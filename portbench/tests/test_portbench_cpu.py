"""Every cell's run, its control and its planted faults, on the CPU at a
tiny size through the program's plain paths (the chip's look skipped).

- A run of each cell, untraced and traced, comes out correct.
- The control, the plain reference in the next precision down put in the
  program's place, comes out not correct.
- Each fault a cell can have, planted under the timed path, comes out not
  correct: the solver's step returning its state unchanged; half of the
  batch left out (its answers copied from the other half); an answer
  altered where it is produced. No cell runs across chips, so none can
  leave an exchange between chips out.
"""

from __future__ import annotations

import contextlib
import dataclasses

import pytest
import torch
from torch.utils import _pytree as pytree

from portbench import control as control_mod
from portbench import manifest
from portbench.tests.helpers import cells, run_tiny, tiny_copy

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def here(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", cells())
def test_run_is_correct(here, cell, trace):
    out = run_tiny(here, cell, SEED, trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = manifest.benchmark(here.parent)
    want = {m["name"] for m in manifest.metrics_of(bench, "per_layer" if trace else "end_to_end", cell)}
    # on the CPU there is no device trace, so the device's metrics are absent
    got = set(out["metrics"])
    assert got <= want
    assert want - got <= {"k1_roofline", "device.idle_pct"} or not trace or "device.idle_pct" in got


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(here, cell):
    wl = manifest.workload(cell, here)
    got = control_mod.readings(cell, SEED, True, "cpu", here)
    failed = [name for name, value in got.items() if not value <= wl["checks"][name]]
    assert failed, got


@contextlib.contextmanager
def patched(target, make):
    from portbench.spans import _resolve

    owner, attr = _resolve(target)
    fn = getattr(owner, attr)
    setattr(owner, attr, make(fn))
    try:
        yield
    finally:
        setattr(owner, attr, fn)


def _unchanged(fn):
    """The LM's step returns its state unchanged: no iteration runs."""
    def wrapper(*args, options, **kwargs):
        return fn(*args, options=dataclasses.replace(options, max_iterations=0), **kwargs)
    return wrapper


def _half(fn):
    """Only the first half of the batch is solved; the second half's
    answers are the first half's."""
    def wrapper(*args, **kwargs):
        b = args[0].shape[0]
        h = b // 2
        def cut(a):
            return a[:h] if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == b else a
        out = fn(*map(cut, args), **{k: cut(v) for k, v in kwargs.items()})
        return pytree.tree_map(
            lambda x: torch.cat([x, x[: b - h]]) if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == h else x,
            out)
    return wrapper


def _altered_facade(fn):
    """The solved camera's cx moved by half a pixel where it is produced."""
    def wrapper(*args, **kwargs):
        seed, pose_ok, out, rms = fn(*args, **kwargs)
        intr = out[1].clone()
        intr[:, 2] += 0.5
        return seed, pose_ok, (out[0], intr, *out[2:]), rms
    return wrapper


def _altered_bundle(fn):
    """The hand-eye translation moved by a millimetre where it is produced."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        g = out[2].clone()
        g[..., 0, 3] += 1e-3
        return (*out[:2], g, *out[3:])
    return wrapper


SCHUR = "calibration_tpu_torch.optim.lm_schur:lm_core_schur"
DENSE = "calibration_tpu_torch.optim.lm:lm_core"
FACADE = "calibration_tpu_torch.parallel.batched:intrinsics_facade_batch"
FACADE_IN_APPS = "calibration_tpu_torch.pipeline.facades.intrinsics:intrinsics_facade_batch"
BUNDLE = "calibration_tpu_torch.parallel.batched:bundle_batch"
FAULTS = {
    "planar-fleet.batch-256": {"unchanged": [(SCHUR, _unchanged)], "half": [(FACADE, _half)],
                               "altered": [(FACADE, _altered_facade)]},
    "robot-cell.bundle-batch-128": {"unchanged": [(DENSE, _unchanged)], "half": [(BUNDLE, _half)],
                                    "altered": [(BUNDLE, _altered_bundle)]},
    "planar-fleet.app-256": {"unchanged": [(SCHUR, _unchanged)], "half": [(FACADE_IN_APPS, _half)],
                             "altered": [(FACADE_IN_APPS, _altered_facade)]},
    "robot-cell.pipeline-64": {"unchanged": [(SCHUR, _unchanged), (DENSE, _unchanged)],
                               "half": [(FACADE_IN_APPS, _half)],
                               "altered": [(FACADE_IN_APPS, _altered_facade)]},
}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", cells())
def test_fault_is_not_correct(here, cell, fault):
    with contextlib.ExitStack() as stack:
        for target, make in FAULTS[cell][fault]:
            stack.enter_context(patched(target, make))
        try:
            out = run_tiny(here, cell, SEED + 1)
        except RuntimeError:
            return  # the fault made the program fail: no answer, not correct
    assert not out["correct"], out["checks"]
