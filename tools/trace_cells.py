#!/usr/bin/env python3
"""The program's spans and counters in one cell of ``portbench`` on one
CUDA card, joined with a device trace.

    python3 tools/trace_cells.py --cell <cell> [--seed N] [--seconds S] [--out DIR]

The cell's inputs come from ``portbench`` (its entry, traffic and seed),
set up and warmed up as ``portbench/run.py`` does. Then, in one process:

1. **The tracer's cost.** Blocks of ``--seconds`` each, spans off and on
   in turn (off, on, off, on), no profiler: problems solved per second in
   each block and the spans recorded per call (every span and sync site
   entered).
2. **A traced window.** ``--seconds`` of calls with spans on and the
   benchmark's synchronised layer wrappers (``portbench.spans.
   layer_timers``) around the program, as a traced benchmark run has
   them: per call, the time inside the outermost ``ingest``,
   ``prefilter``, ``schur``, ``dense`` and ``write`` spans beside the
   wrappers' time for the same layer, and the counters per call
   (``host.syncs``, ``schur.*`` and ``dense.*`` lanes, ``k1.launches.*``,
   ``ransac.rounds.*``).
3. **A profiled stretch** (device activity only, at least 1 s and 2
   calls, wrappers and spans on): the device's idle share inside the
   ``schur`` and ``dense`` spans, the idle time under each span (by the
   innermost span), the ten longest idle gaps, each named by the
   innermost program span at its middle, and whether every launch of K1
   (``cudaLaunchKernel`` of ``projection_kernel``) lies inside a
   ``k1.rms`` span.

One cell per process: a profiler slows the launches of the rest of its
process. Prints one JSON line and writes it to ``<out>/<cell>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from calibration_tpu_torch.utils import profiling  # noqa: E402
from portbench import manifest, program, progtrace, spans  # noqa: E402

LAYERS = ("ingest", "prefilter", "schur", "dense", "write")
K1_KERNEL = "projection_kernel"
SLACK_US = 50.0


def _loop(entry, start_i, seconds, min_calls=1):
    """Calls from ``start_i`` for at least ``seconds`` and ``min_calls``,
    their outcomes read after the last, as ``portbench/run.py`` reads them:
    (next index, calls, problems solved, wall s)."""
    i, kept = start_i, []
    t0 = time.perf_counter()
    while True:
        kept.append(entry.call(i))
        if entry.device == "cuda":
            torch.cuda.synchronize()
        i += 1
        wall = time.perf_counter() - t0
        if wall >= seconds and i - start_i >= min_calls:
            break
    solved = sum(a - f for a, f in map(entry.outcome, kept))
    return i, i - start_i, solved, wall


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _k1_inside(events, mapped):
    """(K1 launches in the trace, launches outside every ``k1.rms`` span
    by more than SLACK_US)."""
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") == "kernel" and K1_KERNEL in e.get("name", "") and "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaLaunchKernel"
                and e.get("args", {}).get("correlation") in corr]
    k1 = [(s.start, s.end) for s in mapped if s.name == "k1.rms"]
    outside = 0
    for e in launches:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if not any(s - SLACK_US <= a and b <= t + SLACK_US for s, t in k1):
            outside += 1
    return len(launches), outside


def trace_cell(cell: str, seed: int, seconds: float, device: str = "cuda", here: Path = manifest.HERE) -> dict:
    """The three measurements of one cell (see the module's docstring);
    ``device`` "cpu" and a tiny copy of ``portbench`` (``here``) rehearse
    them on the CPU, where the profiler records host operations."""
    wl = manifest.workload(cell, here)
    cfg = manifest.config(wl["config"], here)
    entry_mod = manifest.module("entries", wl["entry"], here)
    if device == "cuda":
        torch.cuda.init()
    program.build(device)
    out = {"cell": cell, "seed": seed, "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu"}
    with tempfile.TemporaryDirectory(prefix="trace-cells-") as workdir:
        entry = entry_mod.Entry(cfg, wl["traffic"], seed % 2**63, device, Path(workdir))
        i = 0
        for _ in range(entry.fleets):
            i, *_ = _loop(entry, i, 0.0)

        # 1. spans off against on, no profiler
        blocks = []
        for on in (False, True, False, True):
            with profiling.tracing() if on else contextlib.nullcontext() as handle:
                i, calls, solved, wall = _loop(entry, i, seconds)
                n_spans = len(handle.drain().spans) if on else 0
            blocks.append({"spans": on, "solves_per_s": solved / wall, "calls": calls,
                           "spans_per_call": n_spans / calls})
        out["cost"] = blocks

        # 2. a traced window under the benchmark's wrappers
        before = profiling.counters()
        with spans.layer_timers(device, entry.spans) as outside, profiling.tracing() as handle:
            i, calls, solved, wall = _loop(entry, i, seconds)
            drained = handle.drain()
            window = {"calls": calls, "solves_per_s": solved / wall, "spans_per_call": len(drained.spans) / calls}
            per_call = {}
            for name in LAYERS:
                runs = progtrace.outermost(progtrace.program_spans(drained, 0), name)
                if runs:
                    wall_us = sum(e - s for s, e in progtrace.union([(s.start, s.end) for s in runs]))
                    per_call[f"{name}.span_ms"] = wall_us * 1e-3 / calls
            for label, s in outside.items():
                per_call[f"{label}.outside_ms"] = s * 1e3 / calls
            c = _delta(profiling.counters(), before)
            window["per_call"] = per_call
            window["counters_per_call"] = {k: v / calls for k, v in sorted(c.items())}
            for layer in ("schur", "dense"):
                if c.get(f"{layer}.lanes"):
                    window[f"{layer}.rephased_pct"] = 100.0 * c.get(f"{layer}.rephased_lanes", 0) / c[f"{layer}.lanes"]
            out["window"] = window

            # 3. a profiled stretch, device activity only
            act = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(activities=[act.CUDA if device == "cuda" else act.CPU])
            handle.drain()
            prof.__enter__()
            i, calls, _, wall = _loop(entry, i, 1.0, min_calls=2)
            prof.__exit__(None, None, None)
            drained = handle.drain()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        events = trace.get("traceEvents", [])
        mapped = progtrace.program_spans(drained, int(trace.get("baseTimeNanoseconds", 0)))
        tl = progtrace.Timeline(events)
        host0 = min((s.start for s in mapped), default=0.0)
        host1 = max((s.end for s in mapped), default=0.0)
        a, b = min(host0, tl.busy[0][0] if tl.busy else host0), max(host1, tl.busy[-1][1] if tl.busy else host1)
        idle = tl.idle_by_span(mapped, a, b)
        total_idle = sum(idle.values())
        launches, outside_k1 = _k1_inside(events, mapped)
        out["stretch"] = {
            "calls": calls, "wall_s": wall, "timeline_s": (b - a) * 1e-6,
            "device_idle_pct": 100.0 * total_idle / (b - a) if b > a else None,
            "schur.idle_pct": tl.idle_pct(mapped, "schur"), "dense.idle_pct": tl.idle_pct(mapped, "dense"),
            "idle_share_by_span": {k: v / total_idle for k, v in sorted(idle.items(), key=lambda kv: -kv[1])
                                   if v / total_idle >= 0.005},
            "gaps": tl.gaps(mapped),
            "k1_launches": launches, "k1_launches_outside_k1_rms": outside_k1,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 1414)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "trace_cells"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cells: needs a CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    res = trace_cell(args.cell, args.seed, args.seconds)
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / f"{args.cell}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
