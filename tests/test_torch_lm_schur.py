"""Port equivalence: the batched Schur LM (calibration_tpu_torch.optim.
lm_schur) against the JAX engine vmapped over the same problems, both with
the analytic pinhole Jacobian, CPU, float64.

Bars: final cost 1e-10 relative, parameters 1e-8, and iterations,
linearizations and termination exactly equal per lane; that last bar is
what shows the per-lane masks freeze a finished lane the way vmap of
``lax.while_loop`` does. The tangent covariance agrees at 1e-8 relative.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibration_tpu.models.registry import PINHOLE as JPINHOLE
from calibration_tpu.ops import se3 as jse3
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.optim import intrinsics as joi
from calibration_tpu.optim import lm_schur as jlm
from calibration_tpu_torch.optim import OptimOptions
from calibration_tpu_torch.optim import intrinsics as toi
from calibration_tpu_torch.optim import lm_schur as tlm
from torch_helpers import camera_views, one_torch_thread, rel_fro, t64  # noqa: F401

B, V = 3, 5
G_FREE = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1, 1], float)  # skew frozen
LOWER_G = np.array([0.0, 0.0] + [-np.inf] * 8)


def _jax_res(i, q, t, o, u, m):
    return joi._view_residual(JPINHOLE, i, q, t, o, u, m)


def _problem(noise=0.3, seed=7):
    obj, uv, poses, intr_gt = camera_views(B, V, noise=noise, seed=seed)
    rng = np.random.default_rng(seed)
    intr0 = np.tile(intr_gt, (B, 1))
    intr0[:, :4] += rng.normal(0, 4, (B, 4))
    intr0[:, 4:] = 0.0
    rot = np.asarray(jse3.exp_so3(jnp.asarray(rng.normal(0, 0.02, (B, V, 3))))) @ poses[..., :3, :3]
    quats0 = np.asarray(jse3.rotmat_to_quat(jnp.asarray(rot)))
    trans0 = poses[..., :3, 3] + rng.normal(0, 0.01, (B, V, 3))
    mask = np.ones(obj.shape[:-1])
    mask[0, 1, ::4] = 0.0
    return obj, uv, mask, intr0, quats0, trans0


CASES = {
    "huber": dict(options=dict(max_iterations=40, epsilon=1e-9)),
    "plain_lsq": dict(options=dict(max_iterations=40, epsilon=1e-9, huber_delta=0.0)),
    "budget_cut": dict(options=dict(max_iterations=3, epsilon=1e-12)),
    "padded_view": dict(options=dict(max_iterations=40, epsilon=1e-9), invalid=(1, V - 1)),
}


def _solve_both(case):
    spec = CASES[case]
    obj, uv, mask, intr0, quats0, trans0 = _problem()
    view_valid = np.ones((B, V))
    if "invalid" in spec:
        view_valid[spec["invalid"]] = 0.0
        uv[spec["invalid"]] = np.random.default_rng(1).uniform(0, 640, uv.shape[2:])
    mask = mask * view_valid[..., None]
    jopts = JOptimOptions(**spec["options"])

    def one(o, u, m, x, q, t, vv):
        return jlm.lm_core_schur(
            _jax_res, x, q, t, (o, u, m), options=jopts, g_free=jnp.asarray(G_FREE),
            view_valid=vv, lower_g=jnp.asarray(LOWER_G), jac_view_fn=joi._view_residual_jac_pinhole,
        )

    jout = jax.device_get(
        jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (obj, uv, mask, intr0, quats0, trans0, view_valid)))
    )
    tout = tlm.lm_core_schur(
        toi._view_residual, toi._view_residual_jac_pinhole, t64(intr0), t64(quats0), t64(trans0),
        (t64(obj), t64(uv), t64(mask)), options=OptimOptions(**spec["options"]),
        g_free=t64(G_FREE), view_valid=t64(view_valid), lower_g=t64(LOWER_G),
    )
    return jout, tout, (obj, uv, mask, view_valid)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_core_schur_matches_jax(case):
    jout, tout, _ = _solve_both(case)
    np.testing.assert_array_equal(tout.iterations.numpy(), np.asarray(jout.iterations))
    np.testing.assert_array_equal(tout.linearizations.numpy(), np.asarray(jout.linearizations))
    np.testing.assert_array_equal(tout.termination.numpy(), np.asarray(jout.termination))
    np.testing.assert_array_equal(tout.success.numpy(), np.asarray(jout.success))
    np.testing.assert_allclose(tout.initial_cost.numpy(), np.asarray(jout.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(tout.cost.numpy(), np.asarray(jout.cost), rtol=1e-10)
    np.testing.assert_allclose(tout.xg.numpy(), np.asarray(jout.xg), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(tout.quats.numpy(), np.asarray(jout.quats), atol=1e-8)
    np.testing.assert_allclose(tout.trans.numpy(), np.asarray(jout.trans), atol=1e-8)
    if case == "budget_cut":
        assert np.all(tout.iterations.numpy() == 3) and not bool(tout.success.any())
    else:
        assert bool(tout.success.all())
        assert len(set(tout.linearizations.tolist())) > 1, "lanes should finish at different counts"


def test_lanes_are_independent():
    """Solving the batch equals solving each lane alone, counters exactly."""
    obj, uv, mask, intr0, quats0, trans0 = _problem()
    opts = OptimOptions(max_iterations=40, epsilon=1e-9)
    args = [t64(a) for a in (intr0, quats0, trans0, obj, uv, mask)]

    def solve(sl):
        a = [x[sl] for x in args]
        return tlm.lm_core_schur(
            toi._view_residual, toi._view_residual_jac_pinhole, a[0], a[1], a[2], tuple(a[3:]),
            options=opts, g_free=t64(G_FREE), lower_g=t64(LOWER_G),
        )

    full = solve(slice(None))
    for i in range(B):
        alone = solve(slice(i, i + 1))
        for name in ("iterations", "linearizations", "termination"):
            assert getattr(alone, name).item() == getattr(full, name)[i].item()
        np.testing.assert_allclose(alone.cost.numpy(), full.cost[i : i + 1].numpy(), rtol=1e-13)


def test_tangent_covariance_matches_jax():
    jout, tout, (obj, uv, mask, view_valid) = _solve_both("padded_view")
    tan_free = np.concatenate(
        [np.broadcast_to(G_FREE, (B, 10)), np.repeat(view_valid, 3, axis=-1), np.repeat(view_valid, 3, axis=-1)],
        axis=-1,
    )
    c_t, ok_t = tlm.tangent_covariance(
        toi._view_residual, toi._view_residual_jac_pinhole, tout.xg, tout.quats, tout.trans,
        (t64(obj), t64(uv), t64(mask)), tan_free=t64(tan_free), huber_delta=1.0,
    )
    assert bool(ok_t.all())
    for i in range(B):
        c_j, ok_j = jlm.tangent_covariance(
            _jax_res, jnp.asarray(jout.xg[i]), jnp.asarray(jout.quats[i]), jnp.asarray(jout.trans[i]),
            (jnp.asarray(obj[i]), jnp.asarray(uv[i]), jnp.asarray(mask[i])),
            jac_view_fn=joi._view_residual_jac_pinhole, tan_free=jnp.asarray(tan_free[i]), huber_delta=1.0,
        )
        assert bool(ok_j)
        assert rel_fro(c_t[i].numpy(), c_j) < 1e-8


def test_analytic_jacobian_matches_jax():
    obj, uv, mask, intr0, quats0, trans0 = _problem()
    got = toi._view_residual_jac_pinhole(*(t64(a) for a in (intr0, quats0, trans0, obj, uv, mask))).numpy()
    for i in range(B):
        want = jax.vmap(joi._view_residual_jac_pinhole, in_axes=(None, 0, 0, 0, 0, 0))(
            *(jnp.asarray(a) for a in (intr0[i], quats0[i], trans0[i], obj[i], uv[i], mask[i]))
        )
        scale = np.maximum(1.0, np.abs(np.asarray(want)))
        np.testing.assert_allclose(got[i] / scale, np.asarray(want) / scale, atol=1e-12)


def test_options_are_frozen_dataclasses():
    opts = OptimOptions()
    with pytest.raises(dataclasses.FrozenInstanceError):
        opts.epsilon = 1.0  # type: ignore[misc]
    # the port sets no global dtype. Asked of a fresh interpreter: a test of
    # the JAX package run earlier in this worker may have set one.
    code = (
        "import torch\n"
        "import calibration_tpu_torch.parallel, calibration_tpu_torch.apps.planar_intrinsics\n"
        "assert torch.get_default_dtype() == torch.float32, torch.get_default_dtype()\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
