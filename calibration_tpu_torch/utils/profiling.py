"""Tracing and profiling hooks (port of
``calibration_tpu/utils/profiling.py``): a device trace, a wall-clock
timer, and the per-linearization cost curve of the dense LM.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed work with ``torch.profiler`` (CPU activity, and
    the card's kernels when CUDA is available) and write it into
    ``log_dir`` as a Chrome trace, ``trace_<pid>_<ns>.json`` (open it in
    chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
        if bool(cond(state).any()):
            state = step(state)
        costs.append(state.cost)
    return lm.lm_output(init, state), torch.stack(costs, dim=-1)
