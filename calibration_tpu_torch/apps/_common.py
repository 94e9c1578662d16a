"""Shared CLI helpers for the example apps.

A copy of ``calibration_tpu/apps/_common.py``, which is JAX-free but cannot be
imported without importing JAX (``calibration_tpu/__init__.py`` imports it),
plus ``resolve_device`` for the port's ``--device`` option.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch


def resolve_device(name: str) -> torch.device:
    """The torch device an app's ``--device`` names. A CUDA device that is
    not there is an error, never a silent run on the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device '{name}' asked for, but torch.cuda.is_available() is false")
    return device


def load_json_file(path):
    return json.loads(Path(path).read_text())


def resolve_path(base_dir, p):
    p = Path(p)
    return p if p.is_absolute() else Path(base_dir) / p


def split_sensor_entry(entry: str):
    """'sensor_id=path' or bare 'path' (calibration_pipeline.cpp helper)."""
    if "=" in entry:
        sensor_id, path = entry.split("=", 1)
        return sensor_id, path
    return None, entry


def report_to_json(report):
    """PipelineExecutionReport -> summary JSON used by all pipeline apps."""
    stages = []
    for stage in report.stages:
        stage_json = dict(stage.summary)
        stage_json["name"] = stage.name
        stage_json["success"] = stage.success
        stage_json["duration_s"] = round(stage.duration_s, 4)
        stages.append(stage_json)
    return {"success": report.success, "stages": stages}
