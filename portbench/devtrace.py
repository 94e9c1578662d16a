"""Reading a ``torch.profiler`` trace of a stretch of calls.

On the card the profiler records device activity only (CUPTI: every
kernel, copy and fill, and the host's CUDA runtime calls), which slows the
host least; recording every host operation too made a call ten times
slower on the H100. From its Chrome trace this module takes the device's
busy time (the union of the device's activity intervals, not a sum, so
overlapping streams count once), the device time by kernel name, and the
longest idle gaps of the device, each named by what the host was in at
the gap's middle: the innermost benchmark span (``record_function``) and
the innermost host operation or runtime call, or else the device
operation the gap follows.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CATS = ("user_annotation", "gpu_user_annotation")
HOST_CATS = SPAN_CATS + ("cpu_op", "cuda_runtime")
TOP = 10


@dataclasses.dataclass
class Profile:
    window_s: float  # the host wall of the traced stretch
    busy_s: float  # union of device activity inside it
    kernels: dict  # device seconds by operation name
    gaps: list  # [(label, seconds)], longest first
    calls: int  # calls of the window inside the stretch
    k1_bounds_ms: float  # sum of K1's bound over its launches in the stretch


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _host_label(host, mid, before):
    """The innermost span and host operation covering ``mid`` (us), or the
    device operation ``before`` the gap."""
    span, op = None, None
    for cat, start, end, name in host:
        if start > mid:
            break
        if end >= mid:
            if cat in SPAN_CATS:
                span = name
            else:
                op = name
    return f"{span or 'outside spans'}: {op or 'after ' + before[:80]}"


def read_trace(events):
    """(busy_s, kernels, gaps) from the Chrome trace events of a stretch."""
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?")))
        elif cat in HOST_CATS:
            host.append((cat, float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "?")))
    kernels = collections.Counter()
    for start, end, name in device:
        kernels[name] += (end - start) * 1e-6
    merged = _union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    host.sort(key=lambda h: (h[1], -h[2]))
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gaps.append((b - a, a, b))
    gaps.sort(reverse=True)
    starts = [h[1] for h in host]
    ends = sorted((e, name) for _, e, name in device)
    labelled = []
    for length, a, b in gaps[:TOP]:
        mid = 0.5 * (a + b)
        lo = bisect.bisect_right(starts, mid)
        before = ends[max(0, bisect.bisect_right(ends, (a, chr(0x10FFFF))) - 1)][1] if ends else "?"
        labelled.append((_host_label(host[:lo], mid, before), length * 1e-6))
    return busy_s, dict(kernels), labelled


class Stretch:
    """A profiled stretch of calls: ``start()`` before the first call,
    ``stop(window_s, calls, k1_bounds_ms)`` after the last one's
    synchronize."""

    def __init__(self, device):
        import torch

        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CUDA] if device == "cuda" else [act.CPU])

    def start(self):
        self.prof.__enter__()

    def stop(self, window_s, calls, k1_bounds_ms):
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        busy_s, kernels, gaps = read_trace(events)
        return Profile(window_s, busy_s, kernels, gaps, calls, k1_bounds_ms)


def top_ops(kernels):
    """The TOP device operations by time: [[name, seconds], ...]."""
    return [[name[:160], s] for name, s in sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]]
