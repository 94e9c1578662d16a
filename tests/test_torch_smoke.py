"""CPU rehearsal of ``chip_smoke.py``'s app phase, which otherwise runs only
on the card: the same fleet generator at a small size (4 sensors), the app
on the CPU, and the phase's own report checks, so a wrong path, shape or
threshold shows here before a chip run. Also: the script refuses to run
without a card, and outside the repository. No JAX is imported."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from calibration_tpu_torch.ops import ransac
from calibration_tpu_torch.pipeline import loaders

ROOT = Path(__file__).resolve().parent.parent


def test_app_phase_checks_pass_on_cpu(tmp_path):
    """The 2 px threshold keeps every clean point of the generator's views
    (distortion included) and rejects every displaced one; all cameras
    converge at the injected noise; every layer is timed."""
    config, features, displaced = chip_smoke.write_fleet(tmp_path, 4)
    before = ransac.rounds["cpu"]
    reader = loaders.read_detections
    report, wall, seconds = chip_smoke.run_app(config, features, tmp_path / "r.json", "cpu")
    assert loaders.read_detections is reader  # the timers are taken off again
    assert ransac.rounds["cpu"] > before
    chip_smoke.check_fleet_report(report, displaced)
    assert set(seconds) == {"ingest", "prefilter", "solve", "qa_kernel", "report"}
    assert 0 < sum(seconds.values()) <= wall
    chip_smoke.check_parity(report, report, "self")


def test_fleet_generator_does_not_depend_on_fleet_size(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _, small, d_small = chip_smoke.write_fleet(tmp_path / "a", 2)
    _, large, d_large = chip_smoke.write_fleet(tmp_path / "b", 3)
    assert (d_large[:2] == d_small).all()
    assert [Path(p).read_text() for p in large[:2]] == [Path(p).read_text() for p in small]


def test_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_smoke_refuses_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
