"""``utils/profiling.py`` and the dense LM's step function against the JAX
package's, CPU, float64: ``lm_cost_trace`` per linearization within 1e-10
of JAX's ``lm_cost_trace`` and exactly the port's ``lm_core`` (x, cost,
counters), on Rosenbrock starts that stop at different linearizations, a
robust blocked problem, and homographies of the config-1 set; then
``device_trace`` and ``Timer`` on the CPU."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.optim import homography as jhom
from calibration_tpu.optim import lm as jlm
from calibration_tpu.optim import manifold as jman
from calibration_tpu.utils import profiling as jprof
from calibration_tpu_torch.optim import OptimOptions, lm, manifold
from calibration_tpu_torch.optim import homography as thom
from calibration_tpu_torch.parallel import batched as tb
from calibration_tpu_torch.utils import Timer, device_trace, lm_cost_trace
from torch_helpers import one_torch_thread, t64  # noqa: F401

LM_FIELDS = ("x", "cost", "initial_cost", "iterations", "termination", "success", "linearizations")


def _equal_outputs(got, want):
    for name in LM_FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# Rosenbrock's residuals and a constant one, so the minimum cost (0.125)
# is not zero and a relative bar means something at every linearization
def _rosenbrock_t(x):
    return torch.stack([10.0 * (x[:, 1] - x[:, 0] ** 2), 1.0 - x[:, 0], torch.full_like(x[:, 0], 0.5)], dim=-1)


def _rosenbrock_j(x):
    return jnp.array([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0], 0.5])


STARTS = np.array([[-1.2, 1.0], [0.5, 0.5], [2.0, -1.0]])


def test_trace_matches_jax_and_lm_core():
    """Three starts stop at different linearizations: each lane's curve
    equals JAX's, ends at lm_core's cost and is flat after it stops."""
    opts = OptimOptions(huber_delta=0.0, max_iterations=40)
    m = manifold.ProductManifold([manifold.euclid(2)])
    out, costs = lm_cost_trace(_rosenbrock_t, t64(STARTS), m, options=opts)
    _equal_outputs(out, lm.lm_core(_rosenbrock_t, t64(STARTS), m, options=opts))
    assert costs.shape == (3, 40) and bool(out.success.all())
    assert len(set(out.linearizations.tolist())) > 1
    jm = jman.ProductManifold([jman.euclid(2)])
    jopts = JOptimOptions(huber_delta=0.0, max_iterations=40)
    j_out, j_costs = jax.device_get(
        jax.vmap(lambda x0: jprof.lm_cost_trace(_rosenbrock_j, x0, jm, options=jopts))(STARTS)
    )
    np.testing.assert_allclose(costs.numpy(), np.asarray(j_costs), rtol=1e-10)
    for name in ("iterations", "termination", "linearizations"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(j_out, name)))
    for lane in range(3):
        lin = int(out.linearizations[lane])
        assert torch.equal(costs[lane, lin - 1 :], out.cost[lane].expand(40 - lin + 1))
        assert bool((costs[lane, 1:] <= costs[lane, :-1]).all())


def test_trace_stops_at_the_iteration_cap_as_lm_core():
    """Lanes that reach max_iterations unconverged: the port's trace keeps
    lm_core's counters (its step freezes every lane whose cond is false).
    The reference's scan freezes only on ``done``, so past the cap its
    trace counts a linearization per step, a fault of the reference; its
    costs are the port's all the same."""
    starts = STARTS[[0]].repeat(2, 0) * [[1.0, 1.0], [2.5, 5.0]]
    opts = OptimOptions(huber_delta=0.0, max_iterations=5)
    m = manifold.ProductManifold([manifold.euclid(2)])
    out, costs = lm_cost_trace(_rosenbrock_t, t64(starts), m, options=opts)
    _equal_outputs(out, lm.lm_core(_rosenbrock_t, t64(starts), m, options=opts))
    assert not bool(out.success.any()) and bool((out.iterations == 5).all())
    jm = jman.ProductManifold([jman.euclid(2)])
    jopts = JOptimOptions(huber_delta=0.0, max_iterations=5)
    j_core = jax.device_get(jax.vmap(lambda x0: jlm.lm_core(_rosenbrock_j, x0, jm, options=jopts))(starts))
    j_out, j_costs = jax.device_get(
        jax.vmap(lambda x0: jprof.lm_cost_trace(_rosenbrock_j, x0, jm, options=jopts))(starts)
    )
    np.testing.assert_allclose(costs.numpy(), np.asarray(j_costs), rtol=1e-10)
    np.testing.assert_array_equal(out.linearizations.numpy(), np.asarray(j_core.linearizations))
    assert (np.asarray(j_out.linearizations) > np.asarray(j_core.linearizations)).any()


def test_robust_blocked_trace_matches_jax():
    """Huber blocks of two rows, as tests/test_lm_solvers.py runs JAX's."""
    def res_t(x):
        return torch.cat([x - torch.tensor([1.0, 2.0, 3.0], dtype=x.dtype), torch.full_like(x, 0.25)], dim=-1)

    def res_j(x):
        return jnp.concatenate([x - jnp.array([1.0, 2.0, 3.0]), jnp.full(3, 0.25)])

    bids = np.repeat(np.arange(3), 2)
    opts = OptimOptions(huber_delta=1.0, max_iterations=25)
    m3 = manifold.ProductManifold([manifold.euclid(3)])
    x0 = torch.zeros((1, 3), dtype=torch.float64)
    out, costs = lm_cost_trace(res_t, x0, m3, options=opts, block_ids=bids, num_blocks=3)
    _equal_outputs(out, lm.lm_core(res_t, x0, m3, options=opts, block_ids=bids, num_blocks=3))
    j_out, j_costs = jprof.lm_cost_trace(
        res_j, jnp.zeros(3), jman.ProductManifold([jman.euclid(3)]),
        options=JOptimOptions(huber_delta=1.0, max_iterations=25), block_ids=jnp.asarray(bids), num_blocks=3,
    )
    np.testing.assert_allclose(costs[0].numpy(), np.asarray(j_costs), rtol=1e-10)
    assert int(out.iterations[0]) == int(j_out.iterations)


def test_homography_trace_matches_jax_and_the_solve():
    """Config 1's problems: the trace's output is the homography solve's,
    and each curve is JAX's (the port's float64 seed fed to both)."""
    _, src, dst = chip_smoke.homography_problems(4)
    opts = chip_smoke.HOMOG_OPTS
    trace, core = chip_smoke.homography_lm(t64(src), t64(dst), opts)
    out, costs = trace()
    _equal_outputs(out, core())
    jopts = JOptimOptions(max_iterations=opts.max_iterations, compute_covariance=False)
    p0 = thom.h_to_params(tb._homog_seed(t64(src), t64(dst), torch.ones(4, 24, dtype=torch.float64), "f64"))

    def one(p, o, u):
        res = functools.partial(jhom._residual, obj_xy=o, img_uv=u, mask=jnp.ones(o.shape[0]))
        return jprof.lm_cost_trace(res, p, jhom._MANIFOLD, options=jopts,
                                   block_ids=jnp.repeat(jnp.arange(24), 2), num_blocks=24)

    j_out, j_costs = jax.device_get(jax.jit(jax.vmap(one))(p0.numpy(), src, dst))
    np.testing.assert_allclose(costs.numpy(), np.asarray(j_costs), rtol=1e-10)
    np.testing.assert_array_equal(out.linearizations.numpy(), np.asarray(j_out.linearizations))


def test_step_function_runs_lm_core():
    """lm_core is make_lm_step's init, then step while cond: stepping by
    hand gives the same output, and a finished lane keeps every field."""
    m = manifold.ProductManifold([manifold.euclid(2)])
    opts = OptimOptions(huber_delta=0.0, max_iterations=40)
    init, step, cond = lm.make_lm_step(_rosenbrock_t, t64(STARTS), m, options=opts)
    assert isinstance(init, lm.LMState) and bool(cond(init).all())
    state = init
    while bool(cond(state).any()):
        prev, state = state, step(state)
        for lane in torch.nonzero(~cond(prev)).flatten().tolist():
            for a, b in zip(prev, state):
                assert torch.equal(a[lane], b[lane])
    _equal_outputs(lm.lm_output(init, state), lm.lm_core(_rosenbrock_t, t64(STARTS), m, options=opts))
    assert bool(torch.isfinite(state.grad_max).all())


def test_device_trace_and_timer(tmp_path):
    m = manifold.ProductManifold([manifold.euclid(2)])
    with Timer() as t, device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
        lm.lm_core(_rosenbrock_t, t64(STARTS), m, options=OptimOptions(huber_delta=0.0, max_iterations=5))
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1 and t.elapsed > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    # the program's spans, on a track of their own
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert any(e["name"] == "dense.linearize" for e in spans)
    assert {e["tid"] for e in spans}.isdisjoint(e.get("tid") for e in events if e.get("cat") == "cpu_op")
