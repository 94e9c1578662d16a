"""Tracing and profiling hooks (port of
``calibration_tpu/utils/profiling.py``): the program's spans and counters,
a device trace, a wall-clock timer, and the per-linearization cost curve
of the dense LM.

**Spans.** ``span(name)`` marks the host's time in one layer of the
program. Off (the default) it checks one module flag and returns one
shared object that does nothing. Inside ``tracing()`` each span appends a
``Span`` record (name, id, parent id, call id, start and end on
``time.perf_counter_ns()``, thread) when it closes. Spans nest per thread;
the outermost span of a thread opens a new call id and every span under
it shares it (``context`` and ``adopt`` carry both into a worker thread).
No span synchronises the card: a span is the host's time in the layer,
and a device trace supplies the device's.

**Counters.** ``count(name, n)`` is always on: one dict update under one
lock. ``counters()`` is a snapshot. ``sync(site)`` marks a place where the
host blocks on a device value: it counts ``host.syncs`` and, while
tracing, opens the span ``sync.<site>``.

**The clock.** ``tracing()`` samples ``(time.time_ns(),
time.perf_counter_ns())`` when it starts, the anchor. A ``torch.profiler``
Chrome trace puts an event at ``ts * 1000 + baseTimeNanoseconds`` on the
Unix clock, so ``unix_ns(perf_ns, anchor)`` places a span on the device
trace's timeline, among its kernels, copies and runtime calls.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    id: int
    parent: int  # 0 for an outermost span
    call: int
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    thread: int  # threading.get_ident() of the thread that ran it


class Drained(NamedTuple):
    spans: list  # [Span], in the order they closed
    counters: dict
    anchor: tuple  # (time.time_ns(), time.perf_counter_ns()) when tracing started


_on = False
_spans: list = []
_counters: collections.Counter = collections.Counter()
_lock = threading.Lock()
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Off:
    """The shared span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _On:
    __slots__ = ("name", "id", "parent", "call", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_span_ids)
        if stack:
            self.parent, self.call = stack[-1]
        else:
            self.parent, self.call = 0, next(_call_ids)
        stack.append((self.id, self.call))
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        _spans.append(Span(self.name, self.id, self.parent, self.call, self.start, end, threading.get_ident()))
        return False


def span(name: str):
    """A context manager around one layer of the program: the shared
    no-op ``OFF`` unless tracing is on."""
    return _On(name) if _on else OFF


def traced(name: str):
    """Decorator: the whole function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    with _lock:
        _counters[name] += n


def counters() -> dict:
    """A snapshot of every counter."""
    with _lock:
        return dict(_counters)


def sync(site: str):
    """Around a read that blocks the host on the device (``bool(t.any())``,
    ``.item()``, ``nonzero``, ``.cpu()``): counts ``host.syncs`` and, while
    tracing, opens the span ``sync.<site>``."""
    count("host.syncs")
    return _On("sync." + site) if _on else OFF


def context():
    """The innermost open span of this thread as (span id, call id), or
    None: hand it to ``adopt`` in a worker thread."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def adopt(ctx):
    """Spans opened in this thread inside the block are children of
    ``ctx`` (from ``context()`` in the thread that started the work) and
    share its call id."""
    if ctx is None:
        yield
        return
    stack = _stack()
    stack.append(ctx)
    try:
        yield
    finally:
        stack.pop()


class Tracing:
    """The handle ``tracing()`` yields."""

    def __init__(self, anchor: tuple):
        self.anchor = anchor

    def drain(self) -> Drained:
        """The spans closed so far, a snapshot of the counters and the
        anchor; the span list is cleared."""
        with _lock:
            spans = _spans[:]
            del _spans[: len(spans)]
        return Drained(spans, counters(), self.anchor)


@contextlib.contextmanager
def tracing():
    """Spans on inside the block; yields a ``Tracing`` handle."""
    global _on
    prev = _on
    anchor = (time.time_ns(), time.perf_counter_ns())
    _on = True
    try:
        yield Tracing(anchor)
    finally:
        _on = prev


def unix_ns(perf_ns: int, anchor: tuple) -> int:
    """A ``time.perf_counter_ns()`` reading on the Unix clock of a
    ``torch.profiler`` trace, through ``anchor``."""
    return anchor[0] + (perf_ns - anchor[1])


def reset() -> None:
    """Tracing off, every span and counter cleared (for tests)."""
    global _on
    _on = False
    with _lock:
        _spans.clear()
        _counters.clear()
    _local.stack = []


_SPAN_TID = 0x5A000000  # tids of the span tracks in an exported trace


def _chrome_events(drained: Drained, base_ns: int, pid: int) -> list:
    """The drained spans as Chrome trace complete events (``cat``
    "program_span") on a track of their own per thread, at ``ts`` (us)
    after ``base_ns`` on the Unix clock."""
    tids = {}
    events = []
    for s in drained.spans:
        tid = tids.setdefault(s.thread, _SPAN_TID + len(tids))
        start = unix_ns(s.start_ns, drained.anchor) - base_ns
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": tid,
                       "ts": start / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"id": s.id, "parent": s.parent, "call": s.call}})
    for i, tid in enumerate(tids.values()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"calibration_tpu_torch spans {i}"}})
    return events


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed work with ``torch.profiler`` (CPU activity, and
    the card's kernels when CUDA is available) and the program's spans,
    and write both into ``log_dir`` as one Chrome trace,
    ``trace_<pid>_<ns>.json`` (open it in chrome://tracing or Perfetto):
    the spans are complete events on tracks of their own, above the
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    path = Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
    with tracing() as handle, profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    drained = handle.drain()
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    trace["traceEvents"].extend(_chrome_events(drained, int(trace.get("baseTimeNanoseconds", 0)), os.getpid()))
    path.write_text(json.dumps(trace))


class Timer:
    """Wall-clock timer; on exit it first waits for the CUDA work queued so
    far, when CUDA is in use, so ``elapsed`` covers the device's work."""

    def __init__(self) -> None:
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        return False


def lm_cost_trace(residual_fn, x0, manifold, *, options=None, **lm_kwargs):
    """Run the dense LM recording the cost after every LINEARIZATION, for a
    batch of problems: ``lm.make_lm_step``'s step, the one ``lm_core``
    runs, carrying the same state (x, mu, nu, termination) from one step to
    the next, so the trajectory and the returned ``LMOutput`` are exactly
    ``lm_core``'s with the same arguments.

    Entry k of a lane's curve is its cost after linearization k + 1, to be
    read against ``LMOutput.linearizations``, not ``iterations`` (trials:
    accepted steps and rejected re-solves). A lane that has stopped keeps
    its state, so its curve is flat from there; once every lane has
    stopped no step runs.

    Arguments as ``lm.lm_core`` (``data``, ``free_mask``, ``block_ids``,
    ...). Returns (LMOutput, costs (B, max_iterations)).
    """
    from ..optim import lm
    from ..optim.core import OptimOptions

    options = options or OptimOptions()
    init, step, cond = lm.make_lm_step(residual_fn, x0, manifold, options=options, **lm_kwargs)
    state, costs = init, []
    for _ in range(options.max_iterations):
        with sync("dense.outer"):
            go = bool(cond(state).any())
        if go:
            state = step(state)
        costs.append(state.cost)
    return lm.lm_output(init, state), torch.stack(costs, dim=-1)
