"""Finding the benchmark's parts by name.

- ``BENCHMARK.json`` at the root of the checkout: the cells and metrics.
- ``portbench/workloads/<cell>.json``: a cell's configuration, entry,
  traffic and the limits of its correctness checks.
- ``portbench/configs/<config>.json``: a deployment's shapes and options.
- ``portbench/entries/<entry>.py``: the call a window drives (``Entry``:
  ``fleets``, ``spans``, ``call``, ``outcome``, ``counters``, ``judge``,
  ``control``).
- ``portbench/end_to_end/<metric>.py`` and ``portbench/layers/<metric>.py``:
  one reader of one metric each (``read(run)``).

A later cell, configuration, entry or metric is a new file and a new
manifest entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def _named(kind: str, name: str, suffix: str, here: Path) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = here / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def workload(name: str, here: Path = HERE) -> dict:
    return _json(_named("workloads", name, ".json", here))


def config(name: str, here: Path = HERE) -> dict:
    return _json(_named("configs", name, ".json", here))


def module(kind: str, name: str, here: Path = HERE):
    """The module ``portbench/<kind>/<name>.py``, loaded from its file (a
    metric's name may hold dots)."""
    path = _named(kind, name, ".py", here)
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, section: str, cell: str) -> list:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that
    ``cell`` reports: those that list it, and those that list no cells."""
    return [m for m in bench[section] if cell in m.get("workloads", [cell])]
