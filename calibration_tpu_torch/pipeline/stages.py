"""Pipeline stages (port of ``calibration_tpu/pipeline/stages.py``; so far
the intrinsics stage: the stereo, hand-eye and bundle stages come with
their slices).

Status strings, summary structure and the success rule mirror the
reference so report consumers see the same JSON.
"""

from __future__ import annotations

from .facades.intrinsics import PlanarIntrinsicCalibrationFacade
from .pipeline import CalibrationStage, PipelineContext, PipelineStageResult
from .planar_utils import find_camera_config
from .reports import build_camera_report


class IntrinsicStage(CalibrationStage):
    """stages.h:7-11 + intrinsic_stage.cpp, on ``device``."""

    def __init__(self, device):
        self.device = device

    def name(self) -> str:
        return "intrinsics"

    def run(self, context: PipelineContext) -> PipelineStageResult:
        result = PipelineStageResult(name=self.name())
        if not context.has_intrinsics_config():
            result.summary["error"] = "No intrinsics configuration supplied."
            return result
        if not context.dataset.planar_cameras:
            result.summary["error"] = "Dataset does not contain planar camera captures."
            return result

        cfg = context.intrinsics_config()
        facade = PlanarIntrinsicCalibrationFacade(self.device)
        overall = True
        cameras = []
        # fleet dispatch: sensors sharing a (view, point) bucket solve in one
        # batched device call (the reference loops the facade per camera,
        # intrinsic_stage.cpp:33-50)
        jobs, job_rows = [], []
        for detections in context.dataset.planar_cameras:
            sensor_id = detections.sensor_id or "cam0"
            cam_cfg = find_camera_config(cfg, sensor_id)
            row = {"sensor_id": sensor_id}
            cameras.append(row)
            if cam_cfg is None:
                row["status"] = "missing_camera_config"
                overall = False
                continue
            jobs.append((cam_cfg, detections))
            job_rows.append(row)

        for row, (cam_cfg, detections), run in zip(
            job_rows, jobs, facade.calibrate_many(cfg, jobs) if jobs else []
        ):
            sensor_id = row["sensor_id"]
            if isinstance(run, Exception):
                # parity (intrinsic_stage.cpp:46-49)
                row.update(status="calibration_failed", error=str(run))
                overall = False
                continue
            context.intrinsic_results[sensor_id] = run
            entry = build_camera_report(cam_cfg, detections, run)
            entry["sensor_id"] = sensor_id
            entry["tags"] = sorted(detections.tags)
            row.update(entry)

        has_synth = any("synthetic" in d.tags for d in context.dataset.planar_cameras)
        has_recorded = any("recorded" in d.tags for d in context.dataset.planar_cameras)
        result.summary["cameras"] = cameras
        result.summary["gating"] = {"synthetic": has_synth, "recorded": has_recorded}
        result.success = overall and bool(context.intrinsic_results)
        return result
