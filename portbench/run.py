#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up loads the program, builds or loads its kernels (K1 with nvcc, the
codec with g++, into ``build/`` inside the checkout), makes the cell's
inputs from the seed and warms up each of its fleets once. The window is a
closed loop of calls for ``--seconds``: each call takes the next fleet,
ends in ``torch.cuda.synchronize()``, and is counted whole. Then the
outputs of the window are judged against the plain reference
(``portbench/reference``), each compared number beside its limit, and
the last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``.

With ``--trace 1`` the program's layers run inside the benchmark's spans
(``spans.layer_timers``), and after the window a short stretch of further
calls runs under ``torch.profiler`` (device activity only, which costs the
host least), from which come the device's busy time, the kernels' times
and the idle gaps; those calls are judged with the window's.

Without a CUDA device, or with fewer than the cell asks for, the run fails
before set-up. It exits non-zero, and prints no result, if the JAX package,
JAX or the JAX package's benchmark code is loaded when the window has
closed.
"""

from __future__ import annotations


def _process_age_s() -> float | None:
    """Seconds since this process started (Linux), or None."""
    try:
        import os

        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_AGE_AT_START = _process_age_s()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

_T0 = time.perf_counter() - (_AGE_AT_START or 0.0)
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import devtrace, manifest, program, roofline, spans  # noqa: E402

# top-level module names that may not be loaded in a run: JAX, the JAX
# package and its benchmark code
FORBIDDEN = ("jax", "jaxlib", "flax", "calibration_tpu", "benchmarks", "bench", "bench_all", "chip_smoke")
PROFILE_S = 1.0  # the traced stretch: at least this long and at least 2 calls


@dataclasses.dataclass
class Run:
    """What the metric readers see of one run."""

    cell: str
    setup_s: float
    window_s: float
    walls: list
    attempted: int
    failed: int
    calls: int
    spans: dict  # seconds by layer label over the window (traced runs)
    labels: tuple  # the entry's span labels
    counters: dict  # the program's own counters over the window
    profile: devtrace.Profile | None = None
    setup_split: dict = dataclasses.field(default_factory=dict)
    memory_peak: int = 0


def forbidden_modules() -> list:
    return sorted({name.partition(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda", t0: float | None = None,
             here: Path = manifest.HERE):
    """Set up, warm up, run the window and judge it. Returns (Run, checks,
    entry): checks maps each compared number's name to (value, limit)."""
    t0 = time.perf_counter() if t0 is None else t0
    split = {"imports": time.perf_counter() - t0}
    wl = manifest.workload(cell, here)
    cfg = manifest.config(wl["config"], here)
    entry_mod = manifest.module("entries", wl["entry"], here)

    t = time.perf_counter()
    if device == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
    split["cuda_context"] = time.perf_counter() - t

    t = time.perf_counter()
    program.build(device)
    split["builds"] = time.perf_counter() - t

    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        t = time.perf_counter()
        entry = entry_mod.Entry(cfg, wl["traffic"], seed % 2**63, device, Path(workdir))
        _sync(device)
        split["inputs"] = time.perf_counter() - t

        t = time.perf_counter()
        for i in range(entry.fleets):
            entry.call(i)
            _sync(device)
        split["warm_up"] = time.perf_counter() - t
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t0

        layer_ctx = spans.layer_timers(device, entry.spans) if trace else contextlib.nullcontext({})
        k1_ctx = spans.launch_recorder() if trace else contextlib.nullcontext(([], [False]))
        kept, walls = [], []
        profile = None
        with layer_ctx as span_s, k1_ctx as (k1, recording):
            start = time.perf_counter()
            i = 0
            while True:
                c0 = time.perf_counter()
                kept.append(entry.call(i))
                _sync(device)
                c1 = time.perf_counter()
                walls.append(c1 - c0)
                i += 1
                if c1 - start >= seconds:
                    break
            window_s = c1 - start
            span_s = dict(span_s)
            if trace:
                # a stretch of further calls under the profiler, after the
                # window, so the profiler's own cost is in neither the
                # window nor the spans
                stretch = devtrace.Stretch(device)
                recording[0] = True
                stretch.start()
                s_start, s_i = time.perf_counter(), i
                while True:
                    kept.append(entry.call(i))
                    _sync(device)
                    i += 1
                    s_end = time.perf_counter()
                    if s_end - s_start >= PROFILE_S and i - s_i >= 2:
                        break
                recording[0] = False
                bounds = sum(roofline.bound_ms("rms", *shape)[0] for shape in k1)
                profile = stretch.stop(s_end - s_start, i - s_i, bounds)
        memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

        attempted = failed = 0
        for out in kept:
            a, f = entry.outcome(out)
            attempted, failed = attempted + a, failed + f
        run = Run(cell, setup_s, window_s, walls, attempted, failed, len(walls), span_s,
                  tuple(label for _, label in entry.spans), entry.counters(kept), profile, split, memory_peak)
        checks = {name: (value, wl["checks"][name]) for name, value in entry.judge(kept).items()}
    return run, checks, entry


def _number(v):
    """A finite number as it is, or None (JSON null) for a NaN or an
    infinity."""
    v = float(v)
    return v if math.isfinite(v) else None


def passes(value, limit) -> bool:
    """A compared number passes when it is finite and at most its limit; a
    number with no limit set fails."""
    return limit is not None and math.isfinite(float(value)) and float(value) <= limit


def result_line(run: Run, checks: dict, trace: bool, bench: dict, device: str, here: Path = manifest.HERE) -> dict:
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_of(bench, section, run.cell):
        value = manifest.module("layers" if trace else "end_to_end", m["name"], here).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": _number(value), "unit": m["unit"]}
    correct = all(passes(value, limit) for value, limit in checks.values())
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": int(run.memory_peak)} if device == "cuda" else {"platform": "cpu", "count": 1}
    out = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
           "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile.busy_s
        dev["window_s"] = run.profile.window_s
        out["breakdown"] = {"device_ops": devtrace.top_ops(run.profile.kernels),
                            "idle_gaps": [[label, s] for label, s in run.profile.gaps]}
    out["checks"] = {name: {"value": _number(v), "limit": lim} for name, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no cell named {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    # the reference's float32 products stay in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run, checks, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded in the run: {found}", file=sys.stderr)
        return 4
    out = result_line(run, checks, bool(args.trace), bench, "cuda")
    split = ", ".join(f"{k} {v!r} s" for k, v in run.setup_split.items())
    print(f"portbench: {args.workload} seed {args.seed}: setup {run.setup_s!r} s ({split}); window "
          f"{run.window_s!r} s, {run.calls} calls", file=sys.stderr)
    if run.profile is not None:
        print(f"portbench: traced stretch {run.profile.window_s!r} s, {run.profile.calls} calls "
              f"({run.profile.window_s / run.profile.calls!r} s a call; the window's {run.window_s / run.calls!r} s)",
              file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
