"""The program's own spans and counters (``calibration_tpu_torch.utils.
profiling``), read beside a ``torch.profiler`` trace of the device.

- ``counters()``: the program's always-on counter store, or None when the
  program has none.
- ``run_calls(run)``: every call a run made of its entry, warm-up
  included, the span of calls over which those counters ran.
- ``program_spans``: drained spans mapped onto a Chrome trace's timeline
  (``ts`` in us after ``baseTimeNanoseconds``) through the tracer's clock
  anchor.
- ``Timeline``: the device's merged activity; the device time inside a
  span name's intervals, the idle share there, the idle time under each
  span by the innermost span, and the longest idle gaps, each labelled by
  the innermost program span at its middle (``outside the program`` when
  none is open: the caller's own loop) and by the runtime call there or
  the device operation it follows.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside the program"


def counters():
    """A snapshot of the program's counter store, or None when the program
    keeps none."""
    try:
        from calibration_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "counters", None)
    return None if read is None else read()


def run_calls(run) -> int:
    """The calls of ``run``'s entry since the process started: one warm-up
    call per fleet, the window's and the traced stretch's."""
    from portbench import manifest

    wl = manifest.workload(run.cell)
    stretch = run.profile.calls if run.profile is not None else 0
    return int(wl["traffic"]["fleets"]) + run.calls + stretch


@dataclasses.dataclass(frozen=True)
class MappedSpan:
    name: str
    id: int
    parent: int
    call: int
    start: float  # us on the trace's timeline
    end: float
    thread: int


def program_spans(drained, base_ns: int) -> list:
    """``drained.spans`` on the timeline of a trace whose events sit at
    ``ts`` us after ``base_ns`` ns of the Unix clock."""
    unix0, perf0 = drained.anchor
    out = []
    for s in drained.spans:
        start = (unix0 + s.start_ns - perf0 - base_ns) * 1e-3
        end = (unix0 + s.end_ns - perf0 - base_ns) * 1e-3
        out.append(MappedSpan(s.name, s.id, s.parent, s.call, start, end, s.thread))
    return out


def outermost(spans, name: str) -> list:
    """The spans named ``name`` that no span of the same name encloses."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if s.name != name:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != name:
            p = by_id.get(p.parent)
        if p is None:
            out.append(s)
    return out


def union(intervals) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


class Timeline:
    """The device's activity in a Chrome trace (``events``), merged."""

    def __init__(self, events):
        device, runtime = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start = float(e["ts"])
            item = (start, start + float(e["dur"]), e.get("name", "?"))
            if e.get("cat") in DEVICE_CATS:
                device.append(item)
            elif e.get("cat") in RUNTIME_CATS:
                runtime.append(item)
        self.busy = union([(s, e) for s, e, _ in device])
        self._starts = [s for s, _ in self.busy]
        self._cum = [0.0]
        for s, e in self.busy:
            self._cum.append(self._cum[-1] + e - s)
        self._ends = sorted((e, name) for _, e, name in device)
        self._runtime = sorted(runtime)

    def busy_until(self, t: float) -> float:
        """Device-busy us before time ``t``."""
        i = bisect.bisect_right(self._starts, t)
        if i == 0:
            return 0.0
        s, e = self.busy[i - 1]
        return self._cum[i - 1] + min(e, t) - s

    def busy_in(self, a: float, b: float) -> float:
        return max(0.0, self.busy_until(b) - self.busy_until(a)) if b > a else 0.0

    def inside(self, spans, name: str):
        """(wall us, device-busy us) of the union of ``name``'s
        outermost spans."""
        merged = union([(s.start, s.end) for s in outermost(spans, name)])
        wall = sum(e - s for s, e in merged)
        return wall, sum(self.busy_in(s, e) for s, e in merged)

    def idle_pct(self, spans, name: str):
        """100 x (1 - device activity inside ``name``'s spans over their
        wall), or None where no such span ran."""
        wall, busy = self.inside(spans, name)
        return None if wall <= 0 else 100.0 * (1.0 - busy / wall)

    def idle_by_span(self, spans, a: float, b: float) -> dict:
        """The device's idle us in [a, b], by the innermost span open at
        the time (each span's own idle time less its children's), and
        ``OUTSIDE`` for the idle time under no span."""
        def idle(s0, s1):
            s0, s1 = max(s0, a), min(s1, b)
            return 0.0 if s1 <= s0 else (s1 - s0) - self.busy_in(s0, s1)

        own = collections.Counter()
        children = collections.Counter()
        ids = {s.id for s in spans}
        for s in spans:
            i = idle(s.start, s.end)
            own[s.name] += i
            if s.parent in ids:
                children[s.parent] += i
        by_id = {s.id: s for s in spans}
        for pid, i in children.items():
            own[by_id[pid].name] -= i
        own[OUTSIDE] = idle(a, b) - sum(idle(s.start, s.end) for s in spans if s.parent not in ids)
        return dict(own)

    def innermost(self, spans, t: float):
        best = None
        for s in spans:
            if s.start <= t <= s.end and (best is None or s.start >= best.start):
                best = s
        return best

    def gaps(self, spans, top: int = 10) -> list:
        """The ``top`` longest idle gaps between device activity:
        [(label, seconds)], the label "<innermost program span or
        OUTSIDE>: <runtime call at the middle or 'after <device op>'>"."""
        found = sorted(((b0 - a1, a1, b0) for (_, a1), (b0, _) in zip(self.busy, self.busy[1:])), reverse=True)
        out = []
        for length, a, b in found[:top]:
            mid = 0.5 * (a + b)
            s = self.innermost(spans, mid)
            call = None
            for r0, r1, name in self._runtime:
                if r0 > mid:
                    break
                if r1 >= mid:
                    call = name
            if call is None:
                i = bisect.bisect_right(self._ends, (a, chr(0x10FFFF))) - 1
                call = "after " + (self._ends[i][1][:80] if i >= 0 else "?")
            out.append((f"{s.name if s else OUTSIDE}: {call}", length * 1e-6))
        return out
