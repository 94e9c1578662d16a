"""CUDA graphs of an LM's fixed-shape device segments.

Every linearization and every trial of a batched LM solve launches the
same kernels on tensors of the same shapes; only the host's flag reads
decide between them. ``solve`` hands a solve a ``Solve``, whose ``run``
executes one such segment: eagerly, or as a ``torch.cuda.CUDAGraph``
captured once per key and segment and replayed after that, for the host
cost of one launch instead of one per kernel.

- **Which solves are graphed.** Those whose tensors are on CUDA and whose
  caller built a key with ``key``: the segments' functions by their code
  and the values they close over, the static structure of the problem,
  and the shapes and dtypes of its tensors (no tensor value). A key is
  captured on its second sighting in the process: the first runs
  eagerly, so a one-off shape never pays for a capture. Each device keeps
  the ``_CACHE_SIZE`` keys seen last; an evicted key's graphs are freed
  and its next sighting counts as a first. A key whose capture fails (a
  segment that reads a device value on the host, or copies from the
  host) runs eagerly from then on.
- **What a key follows.** A function by its code, the values in its
  closure cells, its defaults and keyword defaults; a
  ``functools.partial`` by its function, its arguments and its keywords;
  a frozen dataclass field by field; a ``torch.dtype`` by its name. A
  closed-over tensor, list, dict or other object gives no key (a tensor's
  address may be reused once it is freed), and so does a function marked
  ``eager`` (one that keeps host state, as a forward-mode Jacobian keeps
  its dual levels and their lock). A key does not follow the module
  globals a function reads: a replay keeps what a global held at capture,
  where an eager run reads it anew. So a keyed function may read module
  functions and constants, never a module-level tensor or any global
  that is rebound.
- **Static buffers.** A graph reads only buffers of its own key: the
  solve's constants, copied in when a solve holds the key
  (``Solve.held``), and its arguments, copied in before each replay
  unless an argument already is the buffer (an output of another segment
  of the key, or the segment's own carried state).
- **Outputs** are buffers of the key, valid until that segment's next
  replay: ``Solve.own`` copies what a caller keeps.

Counters in ``utils.profiling``: ``<prefix>.graph.captures``,
``<prefix>.graph.replays`` and ``<prefix>.graph.eager`` (segments run
eagerly on CUDA, whatever the reason), one per segment run.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading
import types
from typing import Callable, Optional

import torch

from ..utils import profiling

# keys kept per device: a process solves a handful of shapes (a fleet's
# buckets, a phased solve's phases), and each key holds its graphs' memory
_CACHE_SIZE = 8
# nesting of functions, tuples and dataclasses that a key follows
_MAX_DEPTH = 12

_SCALARS = (int, float, bool, str, type(None))


class _Unkeyable(Exception):
    pass


_EAGER = "_lm_graphs_eager"


def eager(fn: Callable) -> Callable:
    """Mark ``fn`` as a function that keeps host state across a segment (a
    forward-mode Jacobian): a key over it is None, so its solves run
    eagerly. Returns ``fn``."""
    setattr(fn, _EAGER, True)
    return fn


def _value_key(v, depth: int = 0):
    if depth > _MAX_DEPTH:
        raise _Unkeyable
    if isinstance(v, _SCALARS):
        return (type(v), v)
    if isinstance(v, torch.dtype):
        return (torch.dtype, str(v))
    if isinstance(v, tuple):
        return (type(v), tuple(_value_key(e, depth + 1) for e in v))
    if dataclasses.is_dataclass(v) and not isinstance(v, type) and v.__dataclass_params__.frozen:
        return (type(v), tuple(_value_key(getattr(v, f.name), depth + 1) for f in dataclasses.fields(v)))
    if type(v) is functools.partial:
        kw = tuple(sorted(v.keywords.items()))
        return (functools.partial, _value_key((v.func, v.args, kw), depth + 1))
    if isinstance(v, types.FunctionType):
        if getattr(v, _EAGER, False):
            raise _Unkeyable
        try:
            cells = tuple(c.cell_contents for c in v.__closure__ or ())
        except ValueError:  # an empty cell
            raise _Unkeyable from None
        kwdefaults = tuple(sorted((v.__kwdefaults__ or {}).items()))
        return (v.__code__, _value_key((cells, v.__defaults__, kwdefaults), depth + 1))
    raise _Unkeyable


def _tensor_key(t):
    if t is None:
        return None
    if not isinstance(t, torch.Tensor):
        raise _Unkeyable
    return (tuple(t.shape), t.dtype)


def key(values: tuple, tensors: tuple):
    """A solve's key, or None where it has none: ``values`` by value
    (ints, floats, bools, strings, None, dtypes, frozen dataclasses,
    functions and partials by what the module docstring says a key
    follows, and tuples of these; a closed-over tensor or an ``eager``
    function makes the solve unkeyable), ``tensors`` (tensors or None) by
    shape and dtype."""
    try:
        return (_value_key(values), tuple(_tensor_key(t) for t in tensors))
    except _Unkeyable:
        return None


class _Graph:
    __slots__ = ("graph", "inputs", "outputs")

    def __init__(self, graph, inputs, outputs):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs

    def replay(self, args) -> tuple:
        for buf, a in zip(self.inputs, args):
            if a is not buf:
                buf.copy_(a)
        self.graph.replay()
        return self.outputs


class _Entry:
    """One key's graphs on one device."""

    def __init__(self, device):
        self.device = device
        self.lock = threading.RLock()
        self.graphs: dict = {}
        self.consts: Optional[tuple] = None
        self.holder = None  # the token of the solve whose constants are loaded
        self.owned: dict = {}  # id -> every buffer of the key
        self.failed = False
        self.stream = None

    def load(self, token, consts: tuple) -> tuple:
        if self.consts is None:
            self.consts = tuple(None if c is None else c.clone() for c in consts)
            self._own(self.consts)
        elif self.holder is not token:
            for buf, c in zip(self.consts, consts):
                if c is not None:
                    buf.copy_(c)
        self.holder = token
        return self.consts

    def _own(self, tensors):
        for t in tensors:
            if t is not None:
                self.owned[id(t)] = t

    def _is_owned(self, t) -> bool:
        return self.owned.get(id(t)) is t

    def capture(self, fn: Callable, consts: tuple, args: tuple, update_from: Optional[int]) -> _Graph:
        inputs = tuple(a if self._is_owned(a) else a.clone() for a in args)
        main = torch.cuda.current_stream(self.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(self.stream):
                # one eager run on the capture stream first: the libraries
                # set up their per-stream handles and workspaces outside the
                # capture
                fn(consts, *inputs)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outs = list(fn(consts, *inputs))
                    seen = set()
                    for i, o in enumerate(outs):
                        if id(o) in seen:  # one tensor returned twice: two buffers
                            outs[i] = o = o.clone()
                        seen.add(id(o))
                    if update_from is not None:
                        for j, o in enumerate(outs):
                            buf = inputs[update_from + j]
                            if o is not buf:
                                buf.copy_(o)
                            outs[j] = buf
                finally:
                    graph.capture_end()
        finally:
            main.wait_stream(self.stream)
        self._own(inputs)
        self._own(outs)
        return _Graph(graph, inputs, tuple(outs))


_caches: dict = {}  # device -> OrderedDict(key -> _Entry)
_caches_lock = threading.Lock()


def _sighting(k, device) -> Optional[_Entry]:
    """The key's entry from its second sighting on; None the first time
    (the key is then entered, and the least recent key evicted past
    ``_CACHE_SIZE``)."""
    with _caches_lock:
        cache = _caches.setdefault(device, collections.OrderedDict())
        entry = cache.get(k)
        if entry is None:
            cache[k] = _Entry(device)
            if len(cache) > _CACHE_SIZE:
                cache.popitem(last=False)
            return None
        cache.move_to_end(k)
        return entry


def clear() -> None:
    """Drop every key and its graphs (for tests)."""
    with _caches_lock:
        _caches.clear()


class Solve:
    """One solve's way of running its segments."""

    def __init__(self, prefix: str, consts: tuple, entry: Optional[_Entry], cuda: bool):
        self._prefix = prefix
        self._consts = consts
        self._entry = entry
        self._cuda = cuda
        self._token = object()
        self._static = None

    @property
    def graphed(self) -> bool:
        return self._entry is not None and not self._entry.failed

    @contextlib.contextmanager
    def held(self):
        """The key held for a run of segments whose outputs feed one
        another: no other solve of the key replays inside the block."""
        if not self.graphed:
            yield
            return
        with self._entry.lock:
            self._static = self._entry.load(self._token, self._consts)
            yield

    def run(self, name: str, fn: Callable, *args, update_from: Optional[int] = None) -> tuple:
        """``fn(consts, *args)``, a tuple of tensors, inside ``held``.
        ``update_from``: the outputs are the new values of
        ``args[update_from:]``, which a graph updates in place."""
        entry = self._entry
        if self.graphed:
            graph = entry.graphs.get(name)
            if graph is not None:
                profiling.count(self._prefix + ".graph.replays")
                return graph.replay(args)
            try:
                graph = entry.capture(fn, self._static, args, update_from)
            except RuntimeError:
                entry.failed = True
                entry.graphs.clear()
            else:
                entry.graphs[name] = graph
                profiling.count(self._prefix + ".graph.captures")
                return graph.replay(args)
        if self._cuda:
            profiling.count(self._prefix + ".graph.eager")
        return tuple(fn(self._consts, *args))

    def own(self, t):
        """``t`` as the caller may keep it: a copy of a graph's buffer."""
        return t.clone() if self.graphed else t


def solve(prefix: str, k, consts: tuple, device) -> Solve:
    """The ``Solve`` of one solve on ``device`` with key ``k`` (None: run
    eagerly); ``consts``: the tensors (or None) every segment reads
    first."""
    cuda = torch.device(device).type == "cuda"
    entry = _sighting(k, torch.device(device)) if (cuda and k is not None) else None
    return Solve(prefix, consts, entry, cuda)
