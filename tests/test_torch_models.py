"""Port equivalence: camera models, SE(3) helpers and the manifold lift
(calibration_tpu_torch.models / ops.se3 / optim.manifold against the JAX
package on the same numpy inputs, CPU, float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from calibration_tpu.models import camera_matrix as jcm
from calibration_tpu.models import pinhole as jpinhole
from calibration_tpu.ops import se3 as jse3
from calibration_tpu.optim import manifold as jmanifold
from calibration_tpu_torch.models import camera_matrix as tcm
from calibration_tpu_torch.models import pinhole as tpinhole
from calibration_tpu_torch.ops import se3 as tse3
from calibration_tpu_torch.optim import manifold as tmanifold
from torch_helpers import one_torch_thread, t64  # noqa: F401

RTOL = 1e-12  # same float64 formulas, different op order at most


def _cameras(b, seed=0):
    rng = np.random.default_rng(seed)
    intr = np.tile(np.array([600.0, 610.0, 320.0, 240.0, 0.3, -0.15, 0.05, 0.01, 1e-4, -2e-4]), (b, 1))
    return intr + rng.normal(0, 1e-3, intr.shape) * np.abs(intr)


def _points(b, n, seed=1):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.3, 0.3, (b, n, 3))
    xyz[..., 2] = rng.uniform(0.6, 1.4, (b, n))
    return xyz


def test_project_matches_jax():
    intr, xyz = _cameras(3), _points(3, 40)
    want = np.asarray(jpinhole.project(jnp.asarray(intr)[:, None, :], jnp.asarray(xyz)))
    got = tpinhole.project(t64(intr)[:, None, :], t64(xyz)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_project_point_jacobians_match_jax():
    intr, xyz = _cameras(3), _points(3, 40)
    j_got, h_got = tpinhole.project_point_jacobians(t64(intr), t64(xyz))
    for i in range(3):
        j_want, h_want = jpinhole.project_point_jacobians(jnp.asarray(intr[i]), jnp.asarray(xyz[i]))
        for got, want in ((j_got[i].numpy(), np.asarray(j_want)), (h_got[i].numpy(), np.asarray(h_want))):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_project_point_jacobians_match_autodiff():
    """The analytic chain rule equals jacfwd of the JAX projection."""
    intr, xyz = _cameras(1)[0], _points(1, 12)[0]
    j_got, h_got = tpinhole.project_point_jacobians(t64(intr), t64(xyz))
    j_ad = jax.vmap(jax.jacfwd(jpinhole.project), in_axes=(None, 0))(jnp.asarray(intr), jnp.asarray(xyz))
    h_ad = jax.vmap(jax.jacfwd(jpinhole.project, argnums=1), in_axes=(None, 0))(
        jnp.asarray(intr), jnp.asarray(xyz)
    )
    np.testing.assert_allclose(j_got.numpy(), np.asarray(j_ad), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_ad), rtol=1e-10, atol=1e-10)


def test_camera_matrix_ops_match_jax():
    k = _cameras(4)[:, :5]
    px = np.random.default_rng(2).uniform(0, 640, (4, 7, 2))
    np.testing.assert_allclose(tcm.matrix(t64(k)).numpy(), np.asarray(jcm.matrix(jnp.asarray(k))), rtol=0)
    norm_t = tcm.normalize(t64(k)[:, None, :], t64(px))
    norm_j = jcm.normalize(jnp.asarray(k)[:, None, :], jnp.asarray(px))
    np.testing.assert_allclose(norm_t.numpy(), np.asarray(norm_j), rtol=RTOL)
    back = tcm.denormalize(t64(k)[:, None, :], norm_t)
    np.testing.assert_allclose(back.numpy(), px, rtol=RTOL)


@pytest.mark.parametrize("with_bounds", [False, True])
def test_sanitize_intrinsics_matches_jax(with_bounds):
    k = np.array(
        [
            [600.0, 610.0, 320.0, 240.0, 0.0],
            [-5.0, np.nan, 1500.0, -3.0, 0.5],
            [np.inf, 10.0, np.nan, 800.0, -0.02],
        ]
    )
    jb = jcm.CalibrationBounds() if with_bounds else None
    tb = tcm.CalibrationBounds() if with_bounds else None
    k_j, bad_j = jcm.sanitize_intrinsics(jnp.asarray(k), jb)
    k_t, bad_t = tcm.sanitize_intrinsics(t64(k), tb)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(bad_t.numpy(), np.asarray(bad_j))


def _rotvecs():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.8, (6, 3))
    w[0] = 0.0  # identity: Taylor branch
    w[1] = [1e-9, -2e-9, 5e-10]  # below the small-angle switch
    w[2] = [np.pi - 1e-3, 0.0, 0.0]  # near pi
    return w


@pytest.mark.parametrize("name", ["exp_so3", "exp_quat"])
def test_rotation_exp_maps_match_jax(name):
    w = _rotvecs()
    want = np.asarray(getattr(jse3, name)(jnp.asarray(w)))
    got = getattr(tse3, name)(t64(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)


def test_quaternion_ops_match_jax():
    w = _rotvecs()
    r = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    q_j = np.asarray(jse3.rotmat_to_quat(jnp.asarray(r)))
    q_t = tse3.rotmat_to_quat(t64(r)).numpy()
    np.testing.assert_allclose(q_t, q_j, rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(tse3.quat_to_rotmat(t64(q_j)).numpy(), r, atol=1e-14)
    q2 = np.roll(q_j, 1, axis=0)
    np.testing.assert_allclose(
        tse3.quat_mul(t64(q_j), t64(q2)).numpy(),
        np.asarray(jse3.quat_mul(jnp.asarray(q_j), jnp.asarray(q2))),
        rtol=RTOL, atol=1e-15,
    )


def test_project_to_so3_and_make_se3_match_jax():
    rng = np.random.default_rng(4)
    m = np.asarray(jse3.exp_so3(jnp.asarray(rng.normal(0, 0.5, (5, 3))))) + rng.normal(0, 0.05, (5, 3, 3))
    np.testing.assert_allclose(
        tse3.project_to_so3(t64(m)).numpy(), np.asarray(jse3.project_to_so3(jnp.asarray(m))), atol=1e-13
    )
    t = rng.normal(0, 1, (5, 3))
    np.testing.assert_array_equal(
        tse3.make_se3(t64(m), t64(t)).numpy(), np.asarray(jse3.make_se3(jnp.asarray(m), jnp.asarray(t)))
    )


def test_manifold_retract_and_lift_match_jax():
    blocks = [("euclid", 4), ("quat", 4), ("quat", 4), ("euclid", 3)]
    rng = np.random.default_rng(6)
    q = np.asarray(jse3.exp_quat(jnp.asarray(rng.normal(0, 0.7, (2, 3)))))
    x = np.concatenate([rng.normal(0, 1, 4), q.ravel(), rng.normal(0, 1, 3)])
    delta = rng.normal(0, 0.1, 13)
    jm, tm = jmanifold.ProductManifold(blocks), tmanifold.ProductManifold(blocks)
    np.testing.assert_allclose(
        tm.retract(t64(x), t64(delta)).numpy(),
        np.asarray(jm.retract(jnp.asarray(x), jnp.asarray(delta))),
        rtol=RTOL, atol=1e-15,
    )
    np.testing.assert_allclose(
        tm.lift_jacobian(t64(x)).numpy(), np.asarray(jm.lift_jacobian(jnp.asarray(x))), atol=1e-15
    )
