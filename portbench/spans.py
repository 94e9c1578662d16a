"""Spans around the program's layers, from the benchmark's own wrappers.

``layer_timers`` is ``chip_smoke.py``'s, frozen here: while it is open,
each named function of the program is replaced by a wrapper that
synchronises the card at both ends and adds the wall time to its layer's
total, and each call also opens a ``torch.profiler.record_function`` of
the layer's name, so a device trace shows which layer the host was in.
``launch_recorder`` records the shape of every launch of the QA kernel K1
(``projection_rms_f32``), from which ``roofline.bound_ms`` gives its bound.
Both are used in traced runs only.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import time

import torch


def _resolve(target):
    """(owner object, attribute) of a target "module:attr" or
    "module:Class.attr"."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for name in parents:
        owner = getattr(owner, name)
    return owner, attr


@contextlib.contextmanager
def layer_timers(device: str, targets):
    """Wall time by layer, each layer closed by a synchronize on the card:
    ``targets`` is a sequence of ("module:attr", label); yields a Counter
    of seconds by label, filled in as the program runs; the wrapped
    functions are restored on exit. A layer called inside another one of
    the same label counts once."""
    seconds = collections.Counter()
    depth = collections.Counter()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def timed(fn, label):
        def wrapper(*args, **kwargs):
            if depth[label]:
                return fn(*args, **kwargs)
            depth[label] += 1
            sync()
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(label):
                    return fn(*args, **kwargs)
            finally:
                sync()
                seconds[label] += time.perf_counter() - t0
                depth[label] -= 1
        return wrapper

    owners = [(*_resolve(target), label) for target, label in targets]
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in owners]
    try:
        for (owner, attr, label), (_, _, fn) in zip(owners, saved):
            setattr(owner, attr, timed(fn, label))
        yield seconds
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


K1_TARGET = "calibration_tpu_torch.parallel.batched:projection_rms_f32"


@contextlib.contextmanager
def launch_recorder(target=K1_TARGET):
    """Records (B, V, N, scalar bytes, mask bytes) of every call of the QA
    kernel's wrapper on a CUDA tensor, one K1 launch each, in a list that
    it yields; ``recording[0]`` switches it on and off."""
    launches = []
    recording = [False]
    owner, attr = _resolve(target)
    fn = getattr(owner, attr)

    def wrapper(c_se3_t, intrs, obj_xy, img_uv, mask):
        if recording[0] and obj_xy.device.type == "cuda" and obj_xy.numel():
            b, v, n = obj_xy.shape[:3]
            launches.append((b, v, n, obj_xy.element_size(), mask.element_size()))
        return fn(c_se3_t, intrs, obj_xy, img_uv, mask)

    setattr(owner, attr, wrapper)
    try:
        yield launches, recording
    finally:
        setattr(owner, attr, fn)
