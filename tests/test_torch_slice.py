"""Port equivalence of the whole planar-intrinsics slice: the fleet facade
``intrinsics_facade_batch`` and the bench path ``intrinsics_batch``, two
phases and covariance on, against the JAX package's defaults (jacfwd
Jacobians) on the same numpy problems, CPU, float64.

Bars: on noisy data the final robust cost agrees within 1e-7 relative and
the f32 QA recheck within 2e-3 relative (parameters are not gated there:
the fx/k3 valley is flat); on noiseless data intrinsics, poses and
view_errors agree within 1e-6 of JAX and of the ground truth, and the
covariance within 1e-6 relative (Frobenius). The iteration budget (40) is
above the phase cap (6), where both packages run the same schedule.
"""

import dataclasses

import jax
import numpy as np
import pytest

from calibration_tpu.models import CalibrationBounds as JBounds
from calibration_tpu.optim import IntrinsicsOptimOptions as JIntrOptions
from calibration_tpu.optim import OptimizerType as JOptimizerType
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.parallel import batched as jb
from calibration_tpu_torch import convert
from calibration_tpu_torch.optim import OptimizerType
from calibration_tpu_torch.parallel import batched as tb
from torch_helpers import camera_views, one_torch_thread, rel_fro  # noqa: F401

B, V = 4, 6
JOPTS = JIntrOptions(core=JOptimOptions(max_iterations=40, epsilon=1e-9, compute_covariance=True))
TOPTS = convert.intrinsics_options(JOPTS)


def _facades(noise, view_valid=None):
    obj, uv, poses, intr_gt = camera_views(B, V, noise=noise, seed=11)
    vv = np.ones((B, V)) if view_valid is None else view_valid
    j = jax.device_get(jb.intrinsics_facade_batch(obj, uv, view_valid=vv, opts=JOPTS, two_phase=True))
    t = convert.to_numpy(
        tb.intrinsics_facade_batch(
            convert.to_tensor(obj, "cpu"), convert.to_tensor(uv, "cpu"),
            view_valid=convert.to_tensor(vv, "cpu"), opts=TOPTS, two_phase=True,
        )
    )
    return j, t, poses, intr_gt


@pytest.fixture(scope="module")
def noisy():
    return _facades(0.2)


@pytest.fixture(scope="module")
def noiseless():
    return _facades(0.0)


def _lm_counters_equal(t_lm, j_lm):
    np.testing.assert_array_equal(t_lm.success, np.asarray(j_lm.success))
    np.testing.assert_array_equal(t_lm.iterations, np.asarray(j_lm.iterations))
    np.testing.assert_array_equal(t_lm.linearizations, np.asarray(j_lm.linearizations))
    np.testing.assert_array_equal(t_lm.termination, np.asarray(j_lm.termination))


def test_facade_seed_matches_jax(noisy):
    (j_seed, j_pose_ok, _, _), (t_seed, t_pose_ok, _, _), _, _ = noisy
    np.testing.assert_allclose(t_seed.kmtx, np.asarray(j_seed.kmtx), rtol=1e-9)
    np.testing.assert_array_equal(t_seed.ok, np.asarray(j_seed.ok))
    np.testing.assert_array_equal(t_pose_ok, np.asarray(j_pose_ok))


def test_facade_matches_jax_noisy(noisy):
    (_, _, j_out, j_rms), (_, _, t_out, t_rms), _, _ = noisy
    assert t_out[0].success.all()
    _lm_counters_equal(t_out[0], j_out[0])
    np.testing.assert_allclose(t_out[0].cost, np.asarray(j_out[0].cost), rtol=1e-7)
    np.testing.assert_allclose(t_rms, np.asarray(j_rms), rtol=2e-3)
    # the QA recheck agrees with the solver's own f64 view errors
    assert np.max(np.abs(t_rms - t_out[3])) < 5e-3
    assert t_out[5].all() and np.isfinite(t_out[4]).all()


def test_facade_noiseless_recovers_truth(noiseless):
    (_, _, j_out, _), (_, _, t_out, _), poses, intr_gt = noiseless
    _, t_intr, t_poses, t_err, t_cov, t_cov_ok = t_out
    _, j_intr, j_poses, j_err, j_cov, _ = j_out
    for want in (np.asarray(j_intr), np.broadcast_to(intr_gt * [1, 1, 1, 1, 0, 1, 1, 1, 1, 1], t_intr.shape)):
        np.testing.assert_allclose(t_intr, want, atol=1e-6)
    np.testing.assert_allclose(t_poses, np.asarray(j_poses), atol=1e-6)
    np.testing.assert_allclose(t_poses, poses, atol=1e-6)
    np.testing.assert_allclose(t_err, np.asarray(j_err), atol=1e-6)
    assert np.max(t_err) < 1e-6
    assert t_cov_ok.all()
    for i in range(B):
        assert rel_fro(t_cov[i], j_cov[i]) < 1e-6


def test_facade_padded_view_matches_jax():
    vv = np.ones((B, V))
    vv[2, V - 1] = 0.0
    (_, _, j_out, j_rms), (_, _, t_out, t_rms), _, _ = _facades(0.2, view_valid=vv)
    _lm_counters_equal(t_out[0], j_out[0])
    np.testing.assert_allclose(t_out[0].cost, np.asarray(j_out[0].cost), rtol=1e-7)
    valid = vv > 0
    np.testing.assert_allclose(t_rms[valid], np.asarray(j_rms)[valid], rtol=2e-3)
    # the padded view's pose block is frozen at the safe pose
    np.testing.assert_allclose(t_out[2][2, V - 1], np.asarray(j_out[2])[2, V - 1], atol=1e-12)


def test_intrinsics_batch_matches_jax():
    obj, uv, _, _ = camera_views(B, V, noise=0.2, seed=12)
    j_seed, j_out = jax.device_get(jb.intrinsics_batch(obj, uv, opts=JOPTS, two_phase=True))
    t_seed, t_out = convert.to_numpy(
        tb.intrinsics_batch(convert.to_tensor(obj, "cpu"), convert.to_tensor(uv, "cpu"), opts=TOPTS, two_phase=True)
    )
    np.testing.assert_allclose(t_seed.kmtx, np.asarray(j_seed.kmtx), rtol=1e-9)
    assert t_out[0].success.all()
    _lm_counters_equal(t_out[0], j_out[0])
    np.testing.assert_allclose(t_out[0].cost, np.asarray(j_out[0].cost), rtol=1e-7)
    np.testing.assert_allclose(t_out[3], np.asarray(j_out[3]), rtol=1e-6)
    for i in range(B):
        assert rel_fro(t_out[4][i], j_out[4][i]) < 1e-6


def test_single_phase_with_fixed_distortion_matches_jax():
    """The one-solve path (covariance inside the solve) with a pinned
    distortion coefficient (p1 at 0) and a free skew."""
    obj, uv, _, _ = camera_views(B, V, noise=0.2, seed=13)
    jopts = dataclasses.replace(JOPTS, fixed_distortion_indices=(2,), optimize_skew=True)
    j_seed, j_out = jax.device_get(jb.intrinsics_batch(obj, uv, opts=jopts, two_phase=False))
    t_seed, t_out = convert.to_numpy(
        tb.intrinsics_batch(
            convert.to_tensor(obj, "cpu"), convert.to_tensor(uv, "cpu"),
            opts=convert.intrinsics_options(jopts), two_phase=False,
        )
    )
    _lm_counters_equal(t_out[0], j_out[0])
    np.testing.assert_allclose(t_out[0].cost, np.asarray(j_out[0].cost), rtol=1e-7)
    assert np.all(t_out[1][:, 8] == 0.0) and np.any(t_out[1][:, 4] != 0.0)
    for i in range(B):
        assert rel_fro(t_out[4][i], j_out[4][i]) < 1e-6


def test_phase_schedule_keeps_the_budget():
    for total in (1, 6, 7, 40):
        sched = tb._phase_budget(total, (tb.TWO_PHASE_CAP_A,))
        assert sum(sched) == total and sched[0] == min(6, total)
    assert tb._phase_budget(TOPTS.core.max_iterations, (tb.TWO_PHASE_CAP_A,)) == (6, 34)


def test_convert_carries_every_option_field():
    j = JIntrOptions(
        core=JOptimOptions(optimizer=JOptimizerType.DENSE_QR, huber_delta=2.5, epsilon=1e-7,
                           max_iterations=17, compute_covariance=False, verbose=True),
        num_radial=3, optimize_skew=True, bounds=JBounds(fx_min=100.0, cy_max=400.0),
        fixed_distortion_indices=(2,), fixed_distortion_values=(0.01,), mixed_coarse_epsilon=1e-3,
    )
    t = convert.intrinsics_options(j)
    assert t.core.optimizer is OptimizerType.DENSE_QR
    assert dataclasses.asdict(t.core) == {
        **dataclasses.asdict(j.core), "optimizer": OptimizerType.DENSE_QR,
    }
    assert (t.num_radial, t.optimize_skew, t.fixed_distortion_indices, t.fixed_distortion_values) == (
        3, True, (2,), (0.01,),
    )
    assert dataclasses.asdict(t.bounds) == dataclasses.asdict(j.bounds)
    assert t.mixed_coarse_epsilon == 1e-3
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert convert.optim_options(j.core) == t.core
    bounds = JBounds(fx_max=1500.0, skew_min=-0.5)
    assert dataclasses.asdict(convert.calibration_bounds(bounds)) == dataclasses.asdict(bounds)
    assert convert.calibration_bounds(None) is None
