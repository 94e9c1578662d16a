"""The mixed precisions against the JAX package's, CPU: "mixed" (a float32
LM, then the float64 polish) and "mixed_jac" (float32 Jacobians and grams
under a float64 iterate, then the polish) on the intrinsics Schur solver,
"mixed" on the dense intrinsics solver and on the bundle solver.

The float32 phase's trials depend on roundoff, so the port is held to JAX
on the result after the polish, not on the coarse phase's counters: final
cost within 1e-8 relative and the intrinsics within 1e-5 relative
(Frobenius), the same success; and the same against the port's own "f64"
solve. Data: 2 cameras x 4 views of a 5x7 grid at 0.2 px, the solvers
started from the true poses and perturbed intrinsics (intrinsics), 2 rigs
of config 5's set (bundle)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from calibration_tpu.optim import IntrinsicsOptimOptions as JIntrOptions
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.optim import bundle as jbundle
from calibration_tpu.optim import intrinsics as jintr
from calibration_tpu_torch import convert
from calibration_tpu_torch.optim import bundle as tbundle
from calibration_tpu_torch.optim import intrinsics as tintr
from calibration_tpu_torch.optim import lm_schur
from calibration_tpu_torch.parallel import batched as tb
from torch_helpers import camera_views, one_torch_thread, rel_fro, t64  # noqa: F401

B, V = 2, 4
JOPTS = JIntrOptions(core=JOptimOptions(max_iterations=40, epsilon=1e-9, compute_covariance=False))
TOPTS = convert.intrinsics_options(JOPTS)
COST_RTOL = 1e-8
INTR_RTOL = 1e-5


@pytest.fixture(scope="module")
def views():
    obj, uv, poses, intr_gt = camera_views(B, V, noise=0.2, seed=21)
    return obj, uv, poses, intr_gt


@pytest.fixture(scope="module")
def port_f64(views):
    obj, uv, _, _ = views
    return convert.to_numpy(tb.intrinsics_batch(t64(obj), t64(uv), opts=TOPTS, two_phase=False)[1])


def _hold(t_out, j_out, t_f64):
    """The port's (LMOutput, intr, ...) against JAX's and the port's f64."""
    assert t_out[0].success.all()
    np.testing.assert_array_equal(t_out[0].success, np.asarray(j_out[0].success))
    for want in (np.asarray(j_out[0].cost), t_f64[0].cost):
        np.testing.assert_allclose(t_out[0].cost, want, rtol=COST_RTOL)
    for want in (np.asarray(j_out[1]), t_f64[1]):
        for i in range(B):
            assert rel_fro(t_out[1][i], want[i]) < INTR_RTOL


def _inits(views):
    obj, uv, poses, intr_gt = views
    intr0 = np.tile(np.concatenate([intr_gt[:5] + [4.0, -3.0, 2.0, -1.0, 0.0], np.zeros(5)]), (B, 1))
    return obj, uv, intr0, poses


def _solve_both(views, precision, solver):
    """JAX's and the port's optimize_intrinsics_device in ``precision``,
    and the port's "f64", from the same perturbed inits (the device solve
    compiles in half the time of JAX's whole intrinsics_batch)."""
    obj, uv, intr0, poses = _inits(views)
    jsolve = jax.jit(jax.vmap(functools.partial(jintr.optimize_intrinsics_device, opts=JOPTS, precision=precision,
                                                solver=solver)))
    j_out = jax.device_get(jsolve(obj, uv, intr0, poses))
    t_args = (t64(obj), t64(uv), t64(intr0), t64(poses))
    t_out = convert.to_numpy(tintr.optimize_intrinsics_device(*t_args, opts=TOPTS, precision=precision, solver=solver))
    t_f64 = convert.to_numpy(tintr.optimize_intrinsics_device(*t_args, opts=TOPTS, solver=solver))
    return t_out, j_out, t_f64


@pytest.mark.parametrize("precision", ["mixed", "mixed_jac"])
def test_intrinsics_schur_mixed_matches_jax(views, precision):
    _hold(*_solve_both(views, precision, "schur"))


def test_intrinsics_dense_mixed_matches_jax(views):
    _hold(*_solve_both(views, "mixed", "dense"))


def test_bundle_mixed_matches_jax():
    p = chip_smoke.bundle_problems(B, num_obs=8, rows=5, cols=7)
    args = chip_smoke.bundle_args(p, "cpu")
    jopts = jbundle.BundleOptions(core=JOptimOptions(max_iterations=50, compute_covariance=False))
    topts = tbundle.BundleOptions(core=tbundle.OptimOptions(max_iterations=50, compute_covariance=False))
    jsolve = jax.jit(jax.vmap(functools.partial(jbundle.optimize_bundle_device, opts=jopts, precision="mixed",
                                                analytic_jac=True)))
    j_out = jax.device_get(jsolve(*(a.numpy() for a in args)))
    t_out = convert.to_numpy(tbundle.optimize_bundle_device(*args, opts=topts, precision="mixed"))
    t_f64 = convert.to_numpy(tbundle.optimize_bundle_device(*args, opts=topts))
    assert t_out[0].success.all()
    np.testing.assert_array_equal(t_out[0].success, np.asarray(j_out[0].success))
    for want in (np.asarray(j_out[0].cost), t_f64[0].cost):
        np.testing.assert_allclose(t_out[0].cost, want, rtol=COST_RTOL)
    for k in (2, 3):  # g_se3_c, b_se3_t
        np.testing.assert_allclose(t_out[k], np.asarray(j_out[k]), atol=1e-9)


def test_phased_batches_take_the_precision(views, port_f64):
    """intrinsics_batch and intrinsics_facade_batch run "mixed" on their
    phased path too: every phase's solve and the merged result."""
    obj, uv, _, _ = views
    opts = dataclasses.replace(TOPTS, core=dataclasses.replace(TOPTS.core, max_iterations=12))
    seen = []
    real = tintr.optimize_intrinsics_device

    def spy(*args, **kwargs):
        seen.append(kwargs["precision"])
        return real(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tb, "optimize_intrinsics_device", spy)
        _, out = tb.intrinsics_batch(t64(obj), t64(uv), opts=opts, precision="mixed", two_phase=True)
        _, _, fout, _ = tb.intrinsics_facade_batch(t64(obj), t64(uv), opts=opts, precision="mixed", two_phase=True)
    assert seen and set(seen) == {"mixed"}
    for o in (out, fout):
        assert bool(o[0].success.all())
        np.testing.assert_allclose(o[0].cost.numpy(), port_f64[0].cost, rtol=COST_RTOL)


@pytest.mark.parametrize("precision", ["mixed", "mixed_jac"])
def test_coarse_phase_runs_in_float32(views, precision):
    """"mixed" runs its first Schur LM on float32 tensors; "mixed_jac" runs
    it on float64 tensors with float32 Jacobians; the polish is float64."""
    obj, uv, _, _ = views
    calls = []
    real = lm_schur.lm_core_schur

    def spy(res, jac, xg0, *args, **kwargs):
        calls.append((xg0.dtype, kwargs.get("jac_dtype")))
        return real(res, jac, xg0, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm_schur, "lm_core_schur", spy)
        tb.intrinsics_batch(t64(obj), t64(uv), opts=TOPTS, precision=precision, two_phase=False)
    first = (torch.float32, None) if precision == "mixed" else (torch.float64, torch.float32)
    assert calls == [first, (torch.float64, None)]


@pytest.mark.parametrize("call", ["dense_mixed_jac", "bundle_mixed_jac", "schur_unknown", "batch_unknown"])
def test_precisions_a_path_does_not_take_raise(views, call):
    """The reference runs plain float64 for "mixed_jac" on its dense
    intrinsics and bundle solves, silently; the port names what it takes."""
    obj, uv, intr0, poses = _inits(views)
    intr_args = (t64(obj), t64(uv), t64(intr0), t64(poses))
    with pytest.raises(ValueError, match="precision"):
        if call == "dense_mixed_jac":
            tintr.optimize_intrinsics_device(*intr_args, precision="mixed_jac", solver="dense")
        elif call == "bundle_mixed_jac":
            tbundle.optimize_bundle_device(*chip_smoke.bundle_args(chip_smoke.bundle_problems(1, num_obs=4), "cpu"),
                                           precision="mixed_jac")
        elif call == "schur_unknown":
            tintr.optimize_intrinsics_device(*intr_args, precision="bf16")
        else:
            tb.intrinsics_batch(t64(obj), t64(uv), precision="f32")
