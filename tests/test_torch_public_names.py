"""The last public helpers of the reference with a counterpart in the port,
each against its JAX twin on the same numpy inputs, CPU, float64:
``camera_matrix.from_matrix``, ``pinhole.{kmtx_of, dist_of, distort,
undistort_pt}``, ``se3.{se3_identity, pose_to_array, array_to_pose}``,
``planarpose.homography_consistency_fro``, ``lm_schur.full_jacobian`` and
``linalg.{solve_llsq, min_singular_value}`` (by ``torch.linalg.lstsq`` and
``svdvals``; the reference's TPU route, ``svd_lstsq``, is not ported).
Bars: 1e-12 relative (1e-10 for the Jacobian and the solves)."""

import functools

import jax.numpy as jnp
import numpy as np
import torch

from calibration_tpu.models.registry import PINHOLE as JPINHOLE
from calibration_tpu.models import camera_matrix as jcm
from calibration_tpu.models import pinhole as jpin
from calibration_tpu.ops import linalg as jlinalg
from calibration_tpu.ops import planarpose as jplanar
from calibration_tpu.ops import se3 as jse3
from calibration_tpu.optim import intrinsics as jintr
from calibration_tpu.optim import lm_schur as jschur
from calibration_tpu_torch.models import camera_matrix as tcm
from calibration_tpu_torch.models import pinhole as tpin
from calibration_tpu_torch.ops import linalg as tlinalg
from calibration_tpu_torch.ops import planarpose as tplanar
from calibration_tpu_torch.ops import se3 as tse3
from calibration_tpu_torch.optim import blocks
from calibration_tpu_torch.optim import intrinsics as tintr
from calibration_tpu_torch.optim import lm_schur as tschur
from torch_helpers import camera_views, one_torch_thread, t64  # noqa: F401

RNG = np.random.default_rng(41)
INTR = np.array([[600.0, 610.0, 320.0, 240.0, 0.5, -0.12, 0.04, 0.01, 1e-3, -5e-4],
                 [580.0, 590.0, 300.0, 250.0, 0.0, 0.05, -0.02, 0.0, -1e-3, 2e-3]])


def _close(t, j, rtol=1e-12):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=rtol)


def test_camera_matrix_and_pinhole_pieces():
    k = np.concatenate([INTR[:, :5], RNG.uniform(-1, 1, (5, 5))])
    _close(tcm.from_matrix(tcm.matrix(t64(k))), jcm.from_matrix(jcm.matrix(jnp.asarray(k))))
    _close(tpin.kmtx_of(t64(INTR)), jpin.kmtx_of(INTR))
    _close(tpin.dist_of(t64(INTR)), jpin.dist_of(INTR))
    xy = RNG.uniform(-0.4, 0.4, (2, 7, 2))
    intr = INTR[:, None, :]
    _close(tpin.distort(t64(intr), t64(xy)), jpin.distort(intr, xy))
    _close(tpin.undistort_pt(t64(intr), t64(xy)), jpin.undistort_pt(intr, xy))


def test_se3_helpers():
    assert torch.equal(tse3.se3_identity(device="cpu"), torch.eye(4, dtype=torch.float64))
    _close(tse3.se3_identity(torch.float32, device="cpu"), jse3.se3_identity(jnp.float32))
    p6 = np.concatenate([RNG.uniform(-1, 1, (6, 3)), RNG.uniform(-2, 2, (6, 3))], -1)
    _close(tse3.array_to_pose(t64(p6)), jse3.array_to_pose(p6))
    poses = np.asarray(jse3.array_to_pose(p6))
    _close(tse3.pose_to_array(t64(poses)), jse3.pose_to_array(poses))


def test_homography_consistency_fro():
    kmtx = INTR[:1, :5].repeat(4, 0)
    poses = np.asarray(jse3.array_to_pose(np.concatenate([RNG.uniform(-0.3, 0.3, (4, 3)),
                                                          [[0, 0, 1.0]] * 4], -1)))
    h = RNG.normal(size=(4, 3, 3))
    h[3] = 0.0
    got = tplanar.homography_consistency_fro(t64(kmtx), t64(poses), t64(h))
    want = np.asarray(jplanar.homography_consistency_fro(kmtx, poses, h))
    assert bool(torch.isinf(got[3])) and np.isinf(want[3])
    _close(got[:3], want[:3])


def test_full_jacobian_matches_jax():
    """Two cameras of 4 views, pinhole: the port's batch assembly (forward
    mode and the analytic per-view Jacobian) against JAX's per camera."""
    obj, uv, poses, intr_gt = camera_views(2, 4, noise=0.2, seed=43)
    mask = np.ones(obj.shape[:-1])
    intr = INTR
    quats, trans = blocks.poses_to_quat_tran(t64(poses))
    view_data = (t64(obj), t64(uv), t64(mask))
    res = functools.partial(tintr._view_residual, model=tintr.PINHOLE)
    for jac_view in (None, tintr._view_residual_jac_pinhole):
        r, jac = tschur.full_jacobian(res, t64(intr), quats, trans, view_data, jac_view_fn=jac_view)
        assert r.shape == (2, 4 * 2 * obj.shape[2]) and jac.shape == (2, r.shape[1], 10 + 6 * 4)
        for i in range(2):
            j_res = functools.partial(jintr._view_residual, JPINHOLE)
            jr, jj = jschur.full_jacobian(j_res, intr[i], quats[i].numpy(), trans[i].numpy(),
                                          (obj[i], uv[i], mask[i]))
            _close(r[i], jr, rtol=1e-10)
            np.testing.assert_allclose(jac[i].numpy(), np.asarray(jj), rtol=1e-10, atol=1e-8)


def test_least_squares_helpers():
    a = RNG.normal(size=(5, 8, 3))
    b = RNG.normal(size=(5, 8))
    _close(tlinalg.solve_llsq(t64(a), t64(b)), jlinalg.solve_llsq(a, b), rtol=1e-10)
    _close(tlinalg.min_singular_value(t64(a)), jlinalg.min_singular_value(a), rtol=1e-10)
