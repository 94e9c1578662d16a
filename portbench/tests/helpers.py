"""Shared pieces of the benchmark's CPU tests."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from portbench import manifest

# each cell's traffic cut to a size the CPU solves in seconds
TINY = {"sensors": 4, "rigs": 4, "fleets": 2}


def tiny_copy(tmp_path: Path) -> Path:
    """A copy of portbench/ and BENCHMARK.json whose cells have tiny
    traffic and the cells' own limits (the CPU runs the same float64
    solves); returns the copy's portbench directory (pass it as
    ``here``)."""
    here = tmp_path / "portbench"
    shutil.copytree(manifest.HERE, here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for path in (here / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        wl["traffic"].update({k: v for k, v in TINY.items() if k in wl["traffic"]})
        path.write_text(json.dumps(wl))
    return here


def cells():
    return [w["name"] for w in manifest.benchmark()["workloads"]]


def run_tiny(here: Path, cell: str, seed: int, trace: bool = False, seconds: float = 1.0):
    """One run of a tiny cell on the CPU, the chip's look skipped: returns
    the result line."""
    from portbench import run

    torch.set_num_threads(min(4, torch.get_num_threads()))
    res, checks, _ = run.run_cell(cell, seed, seconds, trace, "cpu", here=here)
    return run.result_line(res, checks, trace, manifest.benchmark(here.parent), "cpu", here=here)
