"""Port equivalence: the linear seed (Hartley DLT homography, Zhang K,
planar pose, estimate_intrinsics) against the JAX package on the same numpy
inputs, CPU, float64. Tolerance 1e-9 relative: the port takes the DLT null
vector from an eigendecomposition of the gram where the JAX package runs
inverse power iteration, so the two agree to the conditioning of the
Hartley-normalized system, not to the last bit. Homographies are compared
after their own h22 normalization."""

import jax.numpy as jnp
import numpy as np
import pytest

from calibration_tpu.models import camera_matrix as jcm
from calibration_tpu.ops import homography as jH
from calibration_tpu.ops import intrinsics_linear as jlin
from calibration_tpu.ops import planarpose as jpp
from calibration_tpu.ops import zhang as jzhang
from calibration_tpu_torch.models import camera_matrix as tcm
from calibration_tpu_torch.ops import homography as tH
from calibration_tpu_torch.ops import intrinsics_linear as tlin
from calibration_tpu_torch.ops import planarpose as tpp
from calibration_tpu_torch.ops import zhang as tzhang
from torch_helpers import camera_views, one_torch_thread, t64  # noqa: F401

RTOL = 1e-9


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * np.abs(want).max())


def _views(noise=0.3, seed=5):
    obj, uv, poses, intr_gt = camera_views(3, 6, noise=noise, seed=seed)
    mask = np.ones(obj.shape[:-1], bool)
    mask[1, 2, ::5] = False  # a few dropped corners
    mask[2, 4, :] = False  # one view with no corners at all
    return obj, uv, mask, poses, intr_gt


def test_normalize_points_2d_matches_jax():
    obj, uv, mask, _, _ = _views()
    pn_j, t_j = jH.normalize_points_2d(jnp.asarray(uv), jnp.asarray(mask))
    pn_t, t_t = tH.normalize_points_2d(t64(uv), t64(mask))
    _close(pn_t.numpy(), pn_j, rtol=1e-12)
    _close(t_t.numpy(), t_j, rtol=1e-12)


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_homography_dlt_matches_jax(noise):
    obj, uv, mask, _, _ = _views(noise)
    h_j = np.asarray(jH.estimate_homography_dlt(jnp.asarray(obj), jnp.asarray(uv), jnp.asarray(mask)))
    h_t = tH.estimate_homography_dlt(t64(obj), t64(uv), t64(mask)).numpy()
    valid = mask.sum(-1) >= 4
    for got, want in zip(h_t[valid], h_j[valid]):
        _close(got / got[2, 2], want / want[2, 2])
    rms_j = jH.symmetric_rms_px(jnp.asarray(h_j), jnp.asarray(obj), jnp.asarray(uv), jnp.asarray(mask))
    rms_t = tH.symmetric_rms_px(t64(h_t), t64(obj), t64(uv), t64(mask))
    _close(rms_t.numpy()[valid], np.asarray(rms_j)[valid])


def test_zhang_intrinsics_matches_jax():
    obj, uv, mask, _, intr_gt = _views(0.0)
    hs = np.asarray(jH.estimate_homography_dlt(jnp.asarray(obj), jnp.asarray(uv), jnp.asarray(mask)))
    view_ok = mask.sum(-1) >= 4
    k_t, ok_t = tzhang.zhang_intrinsics_from_hs(t64(hs), t64(view_ok).bool())
    for i in range(3):
        k_j, ok_j = jzhang.zhang_intrinsics_from_hs(jnp.asarray(hs[i]), jnp.asarray(view_ok[i]))
        _close(k_t[i].numpy(), k_j)
        assert bool(ok_t[i]) == bool(ok_j)
    # noiseless homographies of a distorted camera: K near the truth
    np.testing.assert_allclose(k_t[:, :4].numpy(), np.tile(intr_gt[:4], (3, 1)), rtol=0.05)


def test_planar_pose_matches_jax():
    obj, uv, mask, poses, intr_gt = _views(0.2)
    kmtx = np.tile(intr_gt[:5], (3, 6, 1))
    p_j = np.asarray(jpp.estimate_planar_pose(jnp.asarray(obj), jnp.asarray(uv), jnp.asarray(kmtx), jnp.asarray(mask)))
    p_t = tpp.estimate_planar_pose(t64(obj), t64(uv), t64(kmtx), t64(mask)).numpy()
    valid = mask.sum(-1) >= 4
    _close(p_t[valid], p_j[valid])
    np.testing.assert_allclose(p_t[valid][:, :3, 3], poses[valid][:, :3, 3], atol=0.02)

    hs = np.asarray(jH.estimate_homography_dlt(jnp.asarray(obj), jnp.asarray(uv), jnp.asarray(mask)))
    out_j = jpp.pose_from_homography_pixel(jnp.asarray(kmtx), jnp.asarray(hs))
    out_t = tpp.pose_from_homography_pixel(t64(kmtx), t64(hs))
    for got, want in zip(out_t[:3], out_j[:3]):
        _close(got.numpy()[valid], np.asarray(want)[valid])
    np.testing.assert_array_equal(out_t[3].numpy()[valid], np.asarray(out_j[3])[valid])


@pytest.mark.parametrize("with_bounds", [False, True])
def test_estimate_intrinsics_matches_jax(with_bounds):
    obj, uv, mask, _, _ = _views(0.2)
    tb = tcm.CalibrationBounds() if with_bounds else None
    jb = jcm.CalibrationBounds() if with_bounds else None
    est_t = tlin.estimate_intrinsics(t64(obj), t64(uv), t64(mask).bool(), bounds=tb)
    for i in range(3):
        est_j = jlin.estimate_intrinsics(jnp.asarray(obj[i]), jnp.asarray(uv[i]), jnp.asarray(mask[i]), bounds=jb)
        valid = np.asarray(est_j.h_ok)
        np.testing.assert_array_equal(est_t.h_ok[i].numpy(), valid)
        assert bool(est_t.ok[i]) == bool(est_j.ok)
        _close(est_t.kmtx[i].numpy(), est_j.kmtx)
        _close(est_t.c_se3_t[i].numpy()[valid], np.asarray(est_j.c_se3_t)[valid])
        _close(est_t.view_rms[i].numpy()[valid], np.asarray(est_j.view_rms)[valid])


def test_factorizations_poison_failed_lanes_like_jax():
    """A lane that is not SPD (Cholesky) or not finite (SVD, eigh) comes
    back NaN, as in JAX, and never raises; good lanes match JAX."""
    import torch

    from calibration_tpu.ops import linalg as jlinalg
    from calibration_tpu_torch.ops import linalg as tlinalg

    rng = np.random.default_rng(9)
    m = rng.normal(size=(4, 6, 6))
    spd = m @ np.swapaxes(m, -1, -2) + 6 * np.eye(6)
    spd[1] = -spd[1]  # not SPD
    spd[2, 0, 0] = np.nan  # not finite
    rhs = rng.normal(size=(4, 6))
    good = np.array([True, False, False, True])
    for got, want in (
        (tlinalg.spd_solve(t64(spd), t64(rhs)), jlinalg.spd_solve(jnp.asarray(spd), jnp.asarray(rhs))),
        (tlinalg.spd_inverse(t64(spd)), jlinalg.spd_inverse(jnp.asarray(spd))),
    ):
        got = got.numpy()
        assert np.all(np.isnan(got[~good]))
        _close(got[good], np.asarray(want)[good], rtol=1e-12)
    for fn in (tlinalg.svd, tlinalg.eigh):
        outs = fn(t64(spd))
        for o in outs:
            assert torch.isnan(o[2]).all() and torch.isfinite(o[[0, 1, 3]]).all()
