"""The port's tracer (``calibration_tpu_torch/utils/profiling.py``): spans
off by default and free of records, nesting, parent and call ids, spans and
counters from a thread pool, ``drain``, the clock anchor against a
``torch.profiler`` trace on the CPU, and the spans and counters of the
Schur LM's facade on a CPU fleet."""

import json
import os
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from calibration_tpu_torch.optim import IntrinsicsOptimOptions, OptimOptions, lm, manifold
from calibration_tpu_torch.parallel import batched
from calibration_tpu_torch.utils import profiling
from torch_helpers import camera_views, one_torch_thread, t64  # noqa: F401

CLOCK_SLACK_NS = 50_000  # 50 us


@pytest.fixture(autouse=True)
def fresh_tracer():
    """The suite runs several tests per worker process: each test starts
    and leaves the tracer off, with no spans and no counters."""
    profiling.reset()
    yield
    profiling.reset()


def test_off_by_default_records_nothing():
    assert profiling.span("a") is profiling.OFF and profiling.span("b") is profiling.OFF
    with profiling.span("a"), profiling.span("b"):
        pass
    with profiling.sync("site"):
        pass
    assert profiling.counters() == {"host.syncs": 1}
    with profiling.tracing() as handle:
        drained = handle.drain()
    assert drained.spans == [] and profiling.span("a") is profiling.OFF


def test_nesting_parents_and_one_call_id_per_outermost_span():
    with profiling.tracing() as handle:
        with profiling.span("outer"):
            with profiling.span("mid"):
                with profiling.span("inner"):
                    pass
            with profiling.span("mid"):
                pass
        with profiling.span("outer"):
            pass
        drained = handle.drain()
    by_order = {(s.name, i): s for i, s in enumerate(drained.spans)}
    names = [s.name for s in drained.spans]
    assert names == ["inner", "mid", "mid", "outer", "outer"]  # in the order they closed
    inner, mid1, mid2, outer1, outer2 = (by_order[(n, i)] for i, n in enumerate(names))
    assert outer1.parent == 0 and outer2.parent == 0
    assert mid1.parent == outer1.id and mid2.parent == outer1.id and inner.parent == mid1.id
    assert {inner.call, mid1.call, mid2.call} == {outer1.call} and outer2.call != outer1.call
    assert outer1.start_ns <= mid1.start_ns <= inner.start_ns <= inner.end_ns <= mid1.end_ns
    assert mid1.end_ns <= mid2.start_ns <= mid2.end_ns <= outer1.end_ns <= outer2.start_ns
    assert len({s.id for s in drained.spans}) == 5


def test_threads_nest_their_own_spans_and_lose_no_count():
    per_thread = 2000

    def work(k):
        for _ in range(per_thread):
            profiling.count("t.count")
        with profiling.span(f"root{k}"):
            for _ in range(3):
                with profiling.span("child"):
                    profiling.count("t.count", 2)
        return threading.get_ident()

    with profiling.tracing() as handle:
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(work, range(8)))
        drained = handle.drain()
    assert drained.counters["t.count"] == 8 * (per_thread + 3 * 2)
    roots = {s.id: s for s in drained.spans if s.name.startswith("root")}
    children = [s for s in drained.spans if s.name == "child"]
    assert len(roots) == 8 and len(children) == 24
    assert len({r.call for r in roots.values()}) == 8
    for c in children:
        root = roots[c.parent]
        assert c.thread == root.thread and c.call == root.call
        assert root.start_ns <= c.start_ns <= c.end_ns <= root.end_ns


def test_adopt_carries_the_call_into_a_worker_thread():
    with profiling.tracing() as handle:
        with profiling.span("call"):
            ctx = profiling.context()

            def work():
                with profiling.adopt(ctx), profiling.span("shard"):
                    pass

            t = threading.Thread(target=work)
            t.start()
            t.join()
        drained = handle.drain()
    shard, call = drained.spans
    assert (shard.name, call.name) == ("shard", "call")
    assert shard.parent == call.id and shard.call == call.call and shard.thread != call.thread


def test_drain_clears_the_spans_and_keeps_the_counters():
    with profiling.tracing() as handle:
        with profiling.span("a"):
            profiling.count("c", 3)
        first = handle.drain()
        second = handle.drain()
        with profiling.span("b"):
            pass
        third = handle.drain()
    assert [s.name for s in first.spans] == ["a"] and second.spans == [] and [s.name for s in third.spans] == ["b"]
    assert first.counters == second.counters == {"c": 3}
    assert first.anchor == third.anchor and len(first.anchor) == 2


def _rosenbrock(x):
    return torch.stack([10.0 * (x[:, 1] - x[:, 0] ** 2), 1.0 - x[:, 0], torch.full_like(x[:, 0], 0.5)], dim=-1)


def _chrome_events(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    base = int(trace.get("baseTimeNanoseconds", 0))
    out = []
    for e in trace["traceEvents"]:
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("aten::"):
            start = float(e["ts"]) * 1e3 + base
            out.append((e["name"], start, start + float(e["dur"]) * 1e3))
    return out


def test_anchor_maps_spans_onto_the_profiler_clock():
    """lm_core on the CPU under torch.profiler (CPU activity) with tracing
    on: through the anchor every aten:: event lies inside the call's span,
    and every host read of a flag (aten::is_nonzero) inside a
    ``sync.dense.*`` span, to within 50 us."""
    from torch.profiler import ProfilerActivity, profile

    m = manifold.ProductManifold([manifold.euclid(2)])
    starts = t64([[-1.2, 1.0], [0.5, 0.5], [2.0, -1.0]])
    opts = OptimOptions(huber_delta=0.0, max_iterations=20)
    lm.lm_core(_rosenbrock, starts, m, options=opts)  # first-call work outside the trace
    with profiling.tracing() as handle, profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("call"):
            lm.lm_core(_rosenbrock, starts, m, options=opts)
    drained = handle.drain()
    spans = [(s.name, profiling.unix_ns(s.start_ns, drained.anchor), profiling.unix_ns(s.end_ns, drained.anchor))
             for s in drained.spans]
    (_, c0, c1), = [s for s in spans if s[0] == "call"]
    syncs = [(a, b) for name, a, b in spans if name.startswith("sync.dense.")]
    events = [e for e in _chrome_events(prof) if c0 - CLOCK_SLACK_NS <= e[1] <= c1 + CLOCK_SLACK_NS]
    reads = [e for e in events if e[0] == "aten::is_nonzero"]
    assert len(events) > 100 and len(reads) == len(syncs) > 3
    for _, start, end in events:
        assert c0 - CLOCK_SLACK_NS <= start and end <= c1 + CLOCK_SLACK_NS
    for _, start, end in reads:
        assert any(a - CLOCK_SLACK_NS <= start and end <= b + CLOCK_SLACK_NS for a, b in syncs), (start, end)


def test_facade_counts_syncs_lanes_and_one_span_per_linearization():
    """intrinsics_facade_batch on a CPU fleet of 64: the phased solve
    counts every lane once and, as rephased, exactly the lanes that ran past
    the first phase's cap; a one-phase solve opens ``schur.linearize`` once
    per outer iteration of the batch (its largest lane count)."""
    b = batched.TWO_PHASE_MIN_BATCH
    obj, uv, _, _ = camera_views(b, 5, noise=0.2, seed=7)
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=40, compute_covariance=True))
    with profiling.tracing() as handle:
        _, _, out, _ = batched.intrinsics_facade_batch(t64(obj), t64(uv), opts=opts)
        phased = handle.drain()
    c = phased.counters
    assert c["host.syncs"] > 0 and c["schur.lanes"] == b
    assert c.get("schur.rephased_lanes", 0) == int((out[0].iterations > batched.TWO_PHASE_CAP_A).sum())
    assert c.get("k1.launches.rms", 0) == 0  # the CPU computes the plain RMS
    names = [s.name for s in phased.spans]
    assert names.count("schur") == 1 and names.count("schur.seed") == 1 and names.count("k1.rms") == 1
    assert names.count("schur.covariance") == 1 and names.count("schur.phase") >= 1
    assert names.count("sync.phase_split") >= 1 and c["host.syncs"] == sum(n.startswith("sync.") for n in names)
    (root,) = [s for s in phased.spans if s.name == "schur"]
    assert all(s.call == root.call for s in phased.spans)

    with profiling.tracing() as handle:
        _, _, one, _ = batched.intrinsics_facade_batch(t64(obj), t64(uv), opts=opts, two_phase=False)
        single = handle.drain()
    lin = [s for s in single.spans if s.name == "schur.linearize"]
    assert len(lin) == int(one[0].linearizations.max()) > 1
    assert sum(s.name == "schur.trial" for s in single.spans) >= len(lin)
