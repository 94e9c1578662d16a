"""The dense LM's CUDA-graph bookkeeping on the CPU (``optim/lm_graphs``):
the key rule, the per-device LRU of keys, that CPU solves never reach the
graph path, and that the segments a graph would capture make no host read
and no host-to-device copy (either would fail a capture on the card).

The captures and replays themselves run only on a card:
tests/test_torch_cuda.py holds the graphed solves against the eager ones.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from calibration_tpu_torch.models.registry import PINHOLE, SCHEIMPFLUG
from calibration_tpu_torch.optim import BundleOptions, OptimOptions
from calibration_tpu_torch.optim import lm, lm_graphs
from calibration_tpu_torch.optim.manifold import ProductManifold, euclid
from calibration_tpu_torch.parallel import bundle_batch, handeye_batch
from calibration_tpu_torch.utils import profiling

CUDA0 = torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def fresh_caches():
    lm_graphs.clear()
    yield
    lm_graphs.clear()


def _closures(pc, c, model):
    """A residual and Jacobian built as the bundle solve builds its own:
    nested functions over ints and a model spec."""

    def res(x, *d):
        return x * pc + c + model.param_count

    def jac(x, *d):
        return x[..., None] * c

    return res, jac


def _key(res, jac, x=None, options=OptimOptions()):
    x = torch.zeros((4, 3), dtype=torch.float64) if x is None else x
    return lm_graphs.key((res, jac, (("euclid", 3),), options), (x,))


def test_closures_over_ints_and_specs_are_keyed():
    """Each call builds new function objects; equal code and equal closed-
    over values give one key, other values another."""
    first, again = _key(*_closures(10, 1, PINHOLE)), _key(*_closures(10, 1, PINHOLE))
    assert first is not None and first == again and hash(first) == hash(again)
    assert _key(*_closures(10, 2, PINHOLE)) != first
    assert _key(*_closures(10, 1, SCHEIMPFLUG)) != first
    assert _key(*_closures(10, 1, PINHOLE), options=OptimOptions(max_iterations=5)) != first
    assert _key(*_closures(10, 1, PINHOLE), x=torch.zeros((8, 3), dtype=torch.float64)) != first
    assert _key(*_closures(10, 1, PINHOLE), x=torch.zeros((4, 3), dtype=torch.float32)) != first


@pytest.mark.parametrize("value", [torch.ones(3), [1, 2], {"a": 1}, np.ones(2), (1, torch.ones(1))],
                         ids=["tensor", "list", "dict", "numpy", "tuple_with_tensor"])
def test_a_closed_over_tensor_or_mutable_value_gives_no_key(value):
    def res(x, *d):
        return x + len(value)

    def jac(x, *d):
        return x

    assert _key(res, jac) is None
    assert lm_graphs.key((1, 2.0), (torch.ones(2), "not a tensor")) is None


def _keys_of(monkeypatch, fn):
    """The keys the solves inside ``fn()`` asked ``lm_graphs.solve`` for."""
    keys = []
    real = lm_graphs.solve

    def spy(prefix, k, consts, device):
        keys.append(k)
        return real(prefix, k, consts, device)

    monkeypatch.setattr(lm_graphs, "solve", spy)
    fn()
    return keys


def _problem(b=3):
    manifold = ProductManifold([euclid(2)])
    target = torch.arange(2 * b, dtype=torch.float64).reshape(b, 2)

    def res(x, t):
        return x - t

    def jac(x, t):
        return torch.eye(2, dtype=x.dtype).expand(x.shape[0], 2, 2)

    return manifold, target, res, jac


@pytest.mark.parametrize("mode", ["vmap", "dual"])
def test_forward_mode_solves_get_no_key(monkeypatch, mode):
    """jac_fn None (vmap of jacfwd) and the dual-number Jacobian, which
    closes over the manifold: host state, run eagerly."""
    manifold, target, res, _ = _problem()
    jac = lm.forward_jacobian_fn(mode, res, manifold)
    keys = _keys_of(monkeypatch, lambda: lm.lm_core(res, torch.zeros_like(target), manifold, data=(target,),
                                                     jac_fn=jac))
    assert keys == [None]


def _bundle_solve(device="cpu"):
    p = chip_smoke.bundle_problems(4, num_obs=6, rows=3, cols=4)
    opts = BundleOptions(core=OptimOptions(max_iterations=20, compute_covariance=False))
    return bundle_batch(*chip_smoke.bundle_args(p, device), opts=opts, two_phase=False)


def _handeye_solve(rot_residual, device="cpu"):
    _, bg, ct = chip_smoke.handeye_problems(4, num_poses=6)
    ct = ct.copy()
    ct[..., :3, 3] += np.random.default_rng(1).normal(0, 2e-3, ct[..., :3, 3].shape)
    return handeye_batch(torch.as_tensor(bg, device=device), torch.as_tensor(ct, device=device),
                         options=OptimOptions(max_iterations=20, compute_covariance=False),
                         rot_residual=rot_residual)


SOLVES = {
    "bundle": _bundle_solve,
    "handeye_quat": lambda: _handeye_solve("quat"),
    "handeye_log": lambda: _handeye_solve("log"),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_bundle_and_handeye_solves_are_keyed_alike_from_call_to_call(monkeypatch, name):
    """The callers' closures (over pc, c and the model spec, or nothing)
    meet the key rule unchanged: every solve has a key, and the next call
    on the same shapes asks for the same one."""
    keys = _keys_of(monkeypatch, lambda: (SOLVES[name](), SOLVES[name]()))
    assert len(keys) == 2 and keys[0] is not None and keys[0] == keys[1]


def test_the_second_sighting_gets_the_entry_and_the_least_recent_key_is_evicted():
    assert lm_graphs._sighting("a", CUDA0) is None
    entry = lm_graphs._sighting("a", CUDA0)
    assert entry is not None and lm_graphs._sighting("a", CUDA0) is entry
    for i in range(lm_graphs._CACHE_SIZE - 1):
        assert lm_graphs._sighting(i, CUDA0) is None
    assert lm_graphs._sighting("a", CUDA0) is entry  # "a" is now the most recent
    assert lm_graphs._sighting("new", CUDA0) is None  # evicts key 0, the least recent
    assert lm_graphs._sighting(0, CUDA0) is None  # a first sighting again
    assert lm_graphs._sighting("a", CUDA0) is entry
    assert lm_graphs._sighting("a", torch.device("cuda", 1)) is None  # graphs are per device


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_cpu_solves_never_touch_the_graph_path(name):
    before = profiling.counters()
    SOLVES[name]()
    SOLVES[name]()
    after = profiling.counters()
    for counter in ("dense.graph.captures", "dense.graph.replays", "dense.graph.eager"):
        assert after.get(counter, 0) == before.get(counter, 0) == 0
    assert not lm_graphs._caches


# what a segment may not do under a capture: read a device value on the
# host, or build a tensor from host data (a host-to-device copy on CUDA)
FORBIDDEN = {"aten._local_scalar_dense.default", "aten.lift_fresh.default", "aten.nonzero.default",
             "aten.masked_select.default", "aten.repeat_interleave.Tensor"}


class _HostTraffic(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in FORBIDDEN:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _segments_watched(monkeypatch):
    watch = _HostTraffic()
    real = lm_graphs.Solve.run

    def run(self, name, fn, *args, **kwargs):
        with watch:
            return real(self, name, fn, *args, **kwargs)

    monkeypatch.setattr(lm_graphs.Solve, "run", run)
    return watch


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_graphed_segments_make_no_host_read_or_copy(monkeypatch, name):
    watch = _segments_watched(monkeypatch)
    SOLVES[name]()
    assert watch.seen == []


@pytest.mark.parametrize("fault", ["item", "host_tensor"])
def test_the_host_traffic_watch_sees_a_read_and_a_copy(monkeypatch, fault):
    """The watch of the test above, on residuals that do what a capture
    refuses."""
    manifold, target, res, jac = _problem()

    def bad(x, t):
        if fault == "item":
            return (x - t) * float(x.abs().max() >= 0)
        return (x - t) * torch.tensor([1.0, 1.0], dtype=x.dtype)

    watch = _segments_watched(monkeypatch)
    out = lm.lm_core(bad, torch.zeros_like(target), manifold, data=(target,), jac_fn=jac)
    assert bool(out.success.all()) and watch.seen


def test_step_outputs_are_owned_across_steps():
    """A caller that keeps states across steps (``lm_cost_trace``) sees the
    trajectory of ``lm_core``: the same output, each kept cost its own."""
    manifold, target, res, jac = _problem()
    x0 = torch.zeros_like(target) + 5.0
    opts = OptimOptions(max_iterations=6, huber_delta=0.0)
    out = lm.lm_core(res, x0, manifold, data=(target,), options=opts, jac_fn=jac)
    traced, costs = profiling.lm_cost_trace(res, x0, manifold, data=(target,), options=opts, jac_fn=jac)
    for a, b in zip(out, traced):
        assert torch.equal(a, b)
    assert costs.shape == (3, 6) and torch.equal(costs[:, -1], out.cost)
    assert bool((costs[:, :-1] >= costs[:, 1:]).all())
