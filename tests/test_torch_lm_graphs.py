"""The LMs' CUDA-graph bookkeeping on the CPU (``optim/lm_graphs``): the
key rule (partials, dtypes, forward-mode Jacobians marked eager), the
per-device LRU of keys, that CPU solves never reach the graph path, that
the segments a graph would capture make no host read and no host-to-device
copy (either would fail a capture on the card), for the dense and the
Schur LM; ``spd_inverse``'s triangular solves against ``cholesky_solve``;
and the phased solve's padded later phase against the unpadded one.

The captures and replays themselves run only on a card:
tests/test_torch_cuda.py holds the graphed solves against the eager ones.
"""

import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from calibration_tpu_torch.models.registry import PINHOLE, SCHEIMPFLUG
from calibration_tpu_torch.ops import linalg
from calibration_tpu_torch.optim import BundleOptions, ExtrinsicOptions, IntrinsicsOptimOptions, OptimOptions
from calibration_tpu_torch.optim import intrinsics as toi
from calibration_tpu_torch.optim import lm, lm_graphs
from calibration_tpu_torch.optim.manifold import ProductManifold, euclid
from calibration_tpu_torch.parallel import batched, bundle_batch, extrinsics_batch, handeye_batch, intrinsics_batch
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


def _scaled(x, *d, scale=1.0, model=PINHOLE):
    return x * scale + model.param_count


def test_partials_and_dtypes_are_keyed_by_value():
    """A partial by its function, arguments and keywords; a dtype by its
    name: equal values one key, other values another."""
    first = lm_graphs.key((functools.partial(_scaled, scale=2.0), torch.float32), ())
    assert first is not None and first == lm_graphs.key((functools.partial(_scaled, scale=2.0), torch.float32), ())
    assert lm_graphs.key((functools.partial(_scaled, scale=3.0), torch.float32), ()) != first
    assert lm_graphs.key((functools.partial(_scaled, scale=2.0, model=SCHEIMPFLUG), torch.float32), ()) != first
    assert lm_graphs.key((functools.partial(_scaled, 1.0, scale=2.0), torch.float32), ()) != first
    assert lm_graphs.key((functools.partial(_scaled, scale=2.0), torch.float64), ()) != first
    assert lm_graphs.key((functools.partial(_scaled, scale=torch.ones(1)),), ()) is None


def test_a_function_marked_eager_gives_no_key_wherever_it_sits():
    def jac(x, *d):
        return x

    assert lm_graphs.key((jac,), ()) is not None
    lm_graphs.eager(jac)
    assert lm_graphs.key((jac,), ()) is None
    assert lm_graphs.key((functools.partial(jac, 1.0),), ()) is None

    def outer(x):
        return jac(x)

    assert lm_graphs.key((outer,), ()) is None


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


@pytest.mark.parametrize("make_jac", [None, lm.dual_jacobian_fn], ids=["vmap", "dual"])
def test_forward_mode_solves_get_no_key(monkeypatch, make_jac):
    """jac_fn None (vmap of jacfwd) and the dual-number Jacobian, which
    closes over the manifold: host state, run eagerly."""
    manifold, target, res, _ = _problem()
    jac = None if make_jac is None else make_jac(res, manifold)
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


# the Schur LM's solves (``lm_core_schur``): intrinsics through the
# pinhole model's analytic Jacobian, in f64 and in "mixed_jac" (a float32
# Jacobian, then the float64 polish), and the stereo rig's extrinsics
_STEREO_KEYS = ("obj", "uv", "intr0", "c0", "r0")


def _intrinsics_solve(precision="f64", model=PINHOLE.name, max_iterations=40):
    if model == PINHOLE.name:
        obj, uv, _ = chip_smoke.make_problems(4, views=4, rows=5, cols=6)
    else:
        obj, uv, _ = chip_smoke.scheimpflug_problems(4, (0.05, -0.03), views=4, rows=5, cols=6)
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=max_iterations, compute_covariance=False))
    return intrinsics_batch(torch.as_tensor(obj), torch.as_tensor(uv), opts=opts, precision=precision,
                            model_name=model, two_phase=False)


def _stereo_solve(model=PINHOLE.name, max_iterations=30):
    p = chip_smoke.stereo_problems(3, views=4, tilt_tau=None if model == PINHOLE.name else chip_smoke.SOLVER_TILT)
    opts = ExtrinsicOptions(core=OptimOptions(max_iterations=max_iterations, compute_covariance=False))
    return extrinsics_batch(*(torch.as_tensor(p[k]) for k in _STEREO_KEYS), opts=opts, model_name=model,
                            two_phase=False)


SCHUR_SOLVES = {
    "intrinsics": _intrinsics_solve,
    "intrinsics_mixed_jac": lambda: _intrinsics_solve("mixed_jac"),
    "stereo": _stereo_solve,
}


@pytest.mark.parametrize("name", sorted(SCHUR_SOLVES))
def test_schur_solves_are_keyed_alike_from_call_to_call(monkeypatch, name):
    """The residual partials over the model spec and the stereo lambdas
    over pc, c and the spec meet the key rule: every solve has a key, and
    the next call on the same shapes asks for the same ones."""
    both = _keys_of(monkeypatch, lambda: (SCHUR_SOLVES[name](), SCHUR_SOLVES[name]()))
    keys, again = both[: len(both) // 2], both[len(both) // 2 :]
    assert keys and None not in keys and keys == again
    assert len(set(keys)) == (2 if name.endswith("mixed_jac") else 1)  # the float32 phase, then the polish


@pytest.mark.parametrize("name", ["intrinsics_scheimpflug", "stereo_scheimpflug_grouped",
                                  "stereo_scheimpflug_full"])
def test_forward_mode_schur_solves_get_no_key(monkeypatch, name):
    """Scheimpflug has no analytic Jacobian: its forward-mode Jacobians
    (``view_jacobian_fn``, the stereo rig's grouped one) keep host state
    and run eagerly. A solve builds its key before its first segment, so
    one iteration shows it."""
    if name == "stereo_scheimpflug_full":  # extrinsics_batch runs the grouped one
        real = batched.optimize_extrinsics_device
        monkeypatch.setattr(batched, "optimize_extrinsics_device",
                            lambda *a, **kw: real(*a, **kw, jac_mode="full"))
    if name == "intrinsics_scheimpflug":
        keys = _keys_of(monkeypatch, lambda: _intrinsics_solve(model=SCHEIMPFLUG.name, max_iterations=1))
    else:
        keys = _keys_of(monkeypatch, lambda: _stereo_solve(SCHEIMPFLUG.name, max_iterations=1))
    assert keys and set(keys) == {None}
    assert not toi.schur_graphed(SCHEIMPFLUG, CUDA0) and toi.schur_graphed(PINHOLE, CUDA0)
    assert not toi.schur_graphed(PINHOLE, "cpu")


@pytest.mark.parametrize("name", sorted(SCHUR_SOLVES))
def test_cpu_schur_solves_never_touch_the_graph_path(name):
    before = profiling.counters()
    SCHUR_SOLVES[name]()
    SCHUR_SOLVES[name]()
    after = profiling.counters()
    for counter in ("schur.graph.captures", "schur.graph.replays", "schur.graph.eager"):
        assert after.get(counter, 0) == before.get(counter, 0) == 0
    assert not lm_graphs._caches


@pytest.mark.parametrize("name", sorted(SCHUR_SOLVES))
def test_graphed_schur_segments_make_no_host_read_or_copy(monkeypatch, name):
    watch = _segments_watched(monkeypatch)
    SCHUR_SOLVES[name]()
    assert watch.seen == []


def _spd_batch(shape, seed=3):
    rng = np.random.default_rng(seed)
    m = torch.as_tensor(rng.normal(size=shape))
    a = m @ m.mT + shape[-1] * torch.eye(shape[-1], dtype=torch.float64)
    a[0] = -a[0]  # not SPD
    return a


@pytest.mark.parametrize("shape", [(3, 6, 6), (4, 5, 6, 6), (3, 10, 10), (2, 1, 1)])
def test_spd_inverse_is_cholesky_solve_bit_for_bit(shape):
    """Two triangular solves against I (capturable on CUDA), equal to a
    batched ``cholesky_solve`` on the CPU to the last bit; a lane that is
    not SPD comes back NaN and nothing raises."""
    a = _spd_batch(shape)
    low = linalg.cholesky(a)
    eye = torch.eye(shape[-1], dtype=a.dtype).expand(a.shape)
    want = torch.cholesky_solve(eye, low)
    got = linalg.spd_inverse(a)
    assert torch.isnan(got[0]).all() and torch.isfinite(got[1:]).all()
    assert torch.equal(got[1:], want[1:])
    b = torch.as_tensor(np.random.default_rng(4).normal(size=shape[:-1]))
    assert torch.equal(linalg.spd_solve(a, b)[1:], torch.cholesky_solve(b[..., None], low)[1:, ..., 0])


@pytest.mark.parametrize("n, full, lanes", [(1, 256, 16), (16, 256, 16), (17, 256, 32), (41, 256, 64),
                                            (46, 256, 64), (129, 256, 256), (200, 256, 256), (10, 12, 12),
                                            (5, 24, 16), (20, 24, 24)])
def test_padded_lane_counts_are_powers_of_two_from_16_capped_at_the_batch(n, full, lanes):
    assert batched._padded_lanes(n, full) == lanes


@pytest.mark.parametrize("b", [24, 40])
def test_a_padded_phase_b_gives_the_unpadded_result_lane_for_lane(monkeypatch, b):
    """The phased Schur intrinsics solve with its second phase padded (as
    on CUDA with the analytic Jacobian) and unpadded: every output equal
    to the last bit, and the same lanes counted as rephased (the padding
    is not counted)."""
    obj, uv, _ = chip_smoke.make_problems(b, views=6, rows=6, cols=7)
    obj, uv = torch.as_tensor(obj), torch.as_tensor(uv)
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=40, epsilon=1e-9, compute_covariance=False))
    outs, rephased = [], []
    for pad in (False, True):
        monkeypatch.setattr(batched, "schur_graphed", lambda model, device, pad=pad: pad)
        before = profiling.counters().get("schur.rephased_lanes", 0)
        outs.append(intrinsics_batch(obj, uv, opts=opts, two_phase=True)[1])
        rephased.append(profiling.counters().get("schur.rephased_lanes", 0) - before)
    plain, padded = outs
    assert rephased[0] == rephased[1] == int((plain[0].iterations > batched.TWO_PHASE_CAP_A).sum()) > 0
    for want, got in zip(plain[0], padded[0]):
        assert torch.equal(got, want)
    for want, got in zip(plain[1:], padded[1:]):
        assert torch.equal(got, want)
