"""Typed calibration reports (reference:
include/calib/pipeline/reports/intrinsics.h + src/pipeline/reports/intrinsics.cpp).

``build_planar_intrinsics_report`` produces the same structure: type,
algorithm, options, detector metadata, and per-camera sections with the
initial linear guess, refined parameters, warning counts, per-view RMS and
the point-count-weighted global RMS (reports/intrinsics.cpp:12-31).

A copy of ``calibration_tpu/pipeline/reports.py``, which is JAX-free but
cannot be imported without importing JAX (``calibration_tpu/__init__.py``
imports it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from .dataset import PlanarDetections
from .facades.intrinsics import (
    CameraConfig,
    IntrinsicCalibrationConfig,
    IntrinsicCalibrationOutputs,
)
from ..io import jsonio
from ..utils import profiling

REPORT_TYPE = "intrinsics"
REPORT_ALGORITHM_PLANAR = "planar_zhang_lm"


def _weighted_global_rms(view_errors: np.ndarray, counts: List[int]) -> float:
    """Point-count weighted global RMS (reports/intrinsics.cpp:12-31)."""
    if len(counts) == 0 or view_errors.size == 0:
        return 0.0
    n = min(len(counts), view_errors.size)
    w = np.asarray(counts[:n], float)
    e = np.asarray(view_errors[:n], float)
    total = np.sum(w)
    if total <= 0:
        return 0.0
    return float(np.sqrt(np.sum(w * e * e) / total))


@profiling.traced("write")
def build_camera_report(
    cam_cfg: CameraConfig,
    detections: PlanarDetections,
    outputs: IntrinsicCalibrationOutputs,
    include_covariance: bool = False,
) -> Dict[str, Any]:
    refined = outputs.refine_result
    counts = [v.corner_count for v in outputs.active_views]

    def _homography_diag(i):
        """Per-view linear-stage diagnostics (reference carries the full
        HomographyResult into results, estimation/linear/intrinsics.h:26-75)."""
        if i >= len(outputs.view_h_ok):
            return None
        diag = {
            "ok": outputs.view_h_ok[i],
            "symmetric_rms_px": float(outputs.view_h_rms[i]),
        }
        if i < len(outputs.view_inlier_counts):
            diag["inlier_count"] = outputs.view_inlier_counts[i]
            # ndarray.tolist() yields python bools ~10x faster than a
            # bool() comprehension — this line was the largest single host
            # cost of the 64-rig pipeline (0.13s of 0.42s host share)
            diag["inliers"] = outputs.view_inlier_masks[i].tolist()
        return diag

    per_view = [
        {
            "source_image": v.source_image,
            "corner_count": v.corner_count,
            "rms_px": float(refined.view_errors[i]) if i < len(refined.view_errors) else None,
            "homography": _homography_diag(i),
        }
        for i, v in enumerate(outputs.active_views)
    ]
    cam = np.asarray(refined.camera)
    report = {
        "camera_id": cam_cfg.camera_id,
        "model": cam_cfg.model,
        "image_size": cam_cfg.image_size,
        "sensor_id": detections.sensor_id,
        "initial_guess": {
            "kmtx": {
                "fx": float(outputs.linear_kmtx[0]),
                "fy": float(outputs.linear_kmtx[1]),
                "cx": float(outputs.linear_kmtx[2]),
                "cy": float(outputs.linear_kmtx[3]),
                "skew": float(outputs.linear_kmtx[4]),
            },
            "view_indices": list(outputs.linear_view_indices),
        },
        "camera": {
            "kmtx": {
                "fx": float(cam[0]),
                "fy": float(cam[1]),
                "cx": float(cam[2]),
                "cy": float(cam[3]),
                "skew": float(cam[4]),
            },
            "distortion": {"coeffs": [float(x) for x in cam[5:10]]},
            # extra model params beyond the 10-param pinhole packing
            # (Scheimpflug tilt angles; CameraTraits order, scheimpflug.h:236-242)
            **(
                {"tilt": {"tau_x": float(cam[10]), "tau_y": float(cam[11])}}
                if cam.size >= 12
                else {}
            ),
        },
        "warnings": {
            "invalid_k": outputs.invalid_k_warnings,
            "pose_decomposition": outputs.pose_warnings,
            # fleet-path integrity check: views where the independent f32
            # reprojection-RMS recompute disagrees with the solver's f64
            # view_errors (facades.intrinsics.IntrinsicCalibrationOutputs
            # .view_rms_check)
            "rms_check": outputs.rms_check_warnings,
        },
        "statistics": {
            "total_input_views": outputs.total_input_views,
            "accepted_views": outputs.accepted_views,
            "used_views": outputs.used_views,
            "total_points_used": outputs.total_points_used,
            "min_corner_threshold": outputs.min_corner_threshold,
        },
        "per_view": per_view,
        "view_errors": [float(e) for e in np.asarray(refined.view_errors)],
        "global_rms_px": _weighted_global_rms(np.asarray(refined.view_errors), counts),
        "optimization": {
            "success": refined.core.success,
            "final_cost": refined.core.final_cost,
            "report": refined.core.report,
        },
    }
    if include_covariance and refined.core.covariance is not None:
        # NOT serialized by default: the reference's CameraReport carries no
        # covariance (reports/intrinsics.h:40-46) and a 94x94 f64 matrix per
        # camera was 95% of the artifact JSON (5P bench profile, round 4).
        # The matrix stays available in-memory on refine_result.core.
        report["covariance"] = refined.core.covariance.tolist()
    return report


@dataclasses.dataclass
class CalibrationReport:
    """reports/intrinsics.h:14-27 shape."""

    type: str = REPORT_TYPE
    algorithm: str = REPORT_ALGORITHM_PLANAR
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    detector: Dict[str, Any] = dataclasses.field(default_factory=dict)
    cameras: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


@profiling.traced("write")
def build_planar_intrinsics_report(
    cfg: IntrinsicCalibrationConfig,
    entries: List[tuple],  # [(CameraConfig, PlanarDetections, IntrinsicCalibrationOutputs)]
) -> CalibrationReport:
    """reports/intrinsics.cpp:33-84."""
    report = CalibrationReport()
    report.options = jsonio.to_jsonable(cfg.options)
    detectors = {}
    for cam_cfg, detections, outputs in entries:
        report.cameras.append(build_camera_report(cam_cfg, detections, outputs))
        if detections.metadata:
            det = detections.metadata.get("detector")
            if det:
                detectors[detections.sensor_id or cam_cfg.camera_id] = det
    report.detector = detectors
    return report
