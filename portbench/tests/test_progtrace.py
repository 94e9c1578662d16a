"""The readers of the program's own counters, and the join of the
program's spans with a device trace (``portbench/progtrace.py``), on
synthetic runs and traces with known overlaps; then a tiny traced run on
the CPU that reads the counters of the program itself."""

from __future__ import annotations

import pytest

from portbench import devtrace, manifest, progtrace
from portbench.run import Run
from portbench.tests.helpers import run_tiny, tiny_copy

SEED = 2**31 + 77


def _run(cell="planar-fleet.batch-256", calls=40, stretch=3):
    profile = devtrace.Profile(1.0, 0.2, {}, [], stretch, 0.0) if stretch else None
    return Run(cell, 10.0, 51.0, [1.0] * calls, 256 * calls, 0, calls, {}, ("schur",), {}, profile)


def _reader(name):
    return manifest.module("layers", name)


def test_syncs_per_call_counts_every_call_of_the_run(monkeypatch):
    fleets = manifest.workload("planar-fleet.batch-256")["traffic"]["fleets"]
    monkeypatch.setattr(progtrace, "counters", lambda: {"host.syncs": 30 * (fleets + 40 + 3)})
    assert _reader("host.syncs_per_call").read(_run()) == pytest.approx(30.0)
    monkeypatch.setattr(progtrace, "counters", lambda: {"host.syncs": 25 * (fleets + 40)})
    assert _reader("host.syncs_per_call").read(_run(stretch=0)) == pytest.approx(25.0)


def test_rephased_share(monkeypatch):
    monkeypatch.setattr(progtrace, "counters", lambda: {"schur.lanes": 512, "schur.rephased_lanes": 64})
    assert _reader("schur.rephased_pct").read(_run()) == pytest.approx(12.5)
    monkeypatch.setattr(progtrace, "counters", lambda: {"schur.lanes": 512})
    assert _reader("schur.rephased_pct").read(_run()) == 0.0


@pytest.mark.parametrize("found", [None, {}, {"k1.launches.rms": 3}])
def test_counter_readers_are_silent_without_the_counters(monkeypatch, found):
    """A program without the counter store (None) or without these
    counters gives nothing and raises nothing."""
    monkeypatch.setattr(progtrace, "counters", lambda: found)
    assert _reader("host.syncs_per_call").read(_run()) is None
    assert _reader("schur.rephased_pct").read(_run()) is None


class _Drained:
    def __init__(self, spans, anchor):
        self.spans, self.anchor, self.counters = spans, anchor, {}


def _span(name, id_, parent, start_us, end_us, call=1):
    from calibration_tpu_torch.utils.profiling import Span

    # perf_counter_ns readings 1e9 ns behind the trace's clock
    return Span(name, id_, parent, call, int(start_us * 1e3) - 10**9, int(end_us * 1e3) - 10**9, 7)


def _kernel(start, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur}


def test_spans_join_the_device_trace():
    """Spans 0-100 us (``schur``) with children 10-40 (``schur.linearize``)
    and 50-90 (``schur.trial``); kernels 15-25, 30-45 and 60-70 us, one
    more at 120-130 after the call, and a runtime call at 90-100."""
    base = 5 * 10**9
    drained = _Drained([
        _span("schur.linearize", 2, 1, 10, 40),
        _span("schur.trial", 3, 1, 50, 90),
        _span("schur", 1, 0, 0, 100),
    ], anchor=(base + 10**9, 0))
    events = [_kernel(15, 10), _kernel(30, 15, "gemm"), _kernel(60, 10), _kernel(120, 10, "tail"),
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 90, "dur": 10}]
    spans = progtrace.program_spans(drained, base)
    assert [(s.name, s.start, s.end) for s in spans] == [
        ("schur.linearize", 10.0, 40.0), ("schur.trial", 50.0, 90.0), ("schur", 0.0, 100.0)]
    tl = progtrace.Timeline(events)
    assert tl.busy == [[15.0, 25.0], [30.0, 45.0], [60.0, 70.0], [120.0, 130.0]]
    assert tl.inside(spans, "schur") == (100.0, 35.0)
    assert tl.idle_pct(spans, "schur") == pytest.approx(65.0)
    assert tl.idle_pct(spans, "schur.linearize") == pytest.approx(100.0 * (1 - 20 / 30))
    assert tl.idle_pct(spans, "dense") is None
    idle = tl.idle_by_span(spans, 0.0, 130.0)
    # linearize 30 us wall, 20 busy; trial 40 wall, 10 busy; schur's own
    # 30 us (0-10, 40-50, 90-100) with 5 busy (40-45); 100-120 outside
    assert idle == pytest.approx({"schur.linearize": 10.0, "schur.trial": 30.0, "schur": 25.0,
                                  progtrace.OUTSIDE: 20.0})
    gaps = tl.gaps(spans, top=3)
    assert gaps[0] == ("schur: cudaMemcpyAsync", pytest.approx(50e-6))  # 70-120, middle 95
    assert gaps[1] == ("schur.trial: after gemm", pytest.approx(15e-6))  # 45-60, middle 52.5
    assert gaps[2] == ("schur.linearize: after k", pytest.approx(5e-6))  # 25-30


def test_outermost_of_a_name_counts_once():
    drained = _Drained([_span("schur", 2, 1, 10, 20), _span("schur", 1, 0, 0, 100), _span("schur", 3, 0, 200, 250)],
                       anchor=(10**9, 0))
    spans = progtrace.program_spans(drained, 0)
    assert sorted(s.id for s in progtrace.outermost(spans, "schur")) == [1, 3]
    assert progtrace.Timeline([]).inside(spans, "schur") == (150.0, 0.0)


def test_a_tiny_traced_run_reads_the_programs_counters(tmp_path):
    here = tiny_copy(tmp_path)
    out = run_tiny(here, "planar-fleet.batch-256", SEED, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["host.syncs_per_call"]["value"] > 0
