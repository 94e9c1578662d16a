"""On the card only: one short run of each cell through the command the
driver runs, untraced and traced, and its result line. Skips without a
CUDA device (decided in a fixture)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import manifest
from portbench.tests.helpers import cells


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", cells())
def test_short_run(card, cell, trace):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "3000000001",
                           "--seconds", "2", "--trace", str(trace)],
                          cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert out["metrics"].get("k1_roofline", {"value": 0})["value"] <= 105


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cells()[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=manifest.ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
