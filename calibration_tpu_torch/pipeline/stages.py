"""Pipeline stages (port of ``calibration_tpu/pipeline/stages.py``; so far
the intrinsics and stereo stages: the hand-eye and bundle stages come with
their slices).

Status strings, summary structure, artifact layout and the
ok/partial_success/failed aggregation rules mirror the reference so report
consumers see the same JSON.
"""

from __future__ import annotations

import numpy as np

from ..io import jsonio
from .facades.extrinsics import StereoCalibrationFacade
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


def _pose_json(m) -> list:
    return np.asarray(m).tolist()


def _missing(*pairs) -> list:
    return [sensor for sensor, found in pairs if found is None]


class StereoCalibrationStage(CalibrationStage):
    """stereo_stage.cpp:25-164, on ``device``: every pair that passes the
    lookups is solved in one batched call per shape bucket
    (``StereoCalibrationFacade.calibrate_many``)."""

    def __init__(self, device):
        self.device = device

    def name(self) -> str:
        return "stereo"

    def run(self, context: PipelineContext) -> PipelineStageResult:
        result = PipelineStageResult(name=self.name())
        result.summary["input_cameras"] = len(context.intrinsic_results)
        if not context.has_stereo_config():
            result.summary["status"] = "missing_config"
            return result
        if len(context.intrinsic_results) < 2:
            result.summary["status"] = "waiting_for_multiple_intrinsic_results"
            return result

        cfg = context.stereo_config()
        result.summary["requested_pairs"] = len(cfg.pairs)
        if not cfg.pairs:
            result.summary["status"] = "no_pairs_configured"
            return result

        detections_by_sensor = {d.sensor_id: d for d in context.dataset.planar_cameras if d.sensor_id}
        stereo_artifacts = context.artifacts.setdefault("stereo", {})
        stereo_artifacts["pairs"] = {}
        context.stereo_results.clear()

        pairs_summary = []
        all_success, any_success = True, False

        # per-pair config and lookup checks; the device work is deferred
        items, item_pjs = [], []
        for pair_cfg in cfg.pairs:
            pj = {
                "pair_id": pair_cfg.pair_id,
                "reference_sensor": pair_cfg.reference_sensor,
                "target_sensor": pair_cfg.target_sensor,
                "requested_views": len(pair_cfg.views),
            }
            pairs_summary.append(pj)
            ref_intr = context.intrinsic_results.get(pair_cfg.reference_sensor)
            tgt_intr = context.intrinsic_results.get(pair_cfg.target_sensor)
            if ref_intr is None or tgt_intr is None:
                missing = _missing((pair_cfg.reference_sensor, ref_intr), (pair_cfg.target_sensor, tgt_intr))
                pj.update(status="missing_intrinsics", missing=missing, success=False)
                all_success = False
                continue
            ref_det = detections_by_sensor.get(pair_cfg.reference_sensor)
            tgt_det = detections_by_sensor.get(pair_cfg.target_sensor)
            if ref_det is None or tgt_det is None:
                missing = _missing((pair_cfg.reference_sensor, ref_det), (pair_cfg.target_sensor, tgt_det))
                pj.update(status="missing_detections", missing=missing, success=False)
                all_success = False
                continue
            items.append((pair_cfg, ref_det, tgt_det, ref_intr, tgt_intr))
            item_pjs.append(pj)

        solved = StereoCalibrationFacade(self.device).calibrate_many(items) if items else []

        # reports, in pair order
        for (pair_cfg, *_), pj, pr in zip(items, item_pjs, solved):
            if isinstance(pr, Exception):
                # parity (stereo_stage.cpp:141-146)
                pj.update(status="calibration_error", error=str(pr), success=False)
                all_success = False
                continue
            pj["views"] = [jsonio.to_jsonable(v) for v in pr.view_summaries]
            pj["used_views"] = pr.used_views
            pj["success"] = pr.success
            pj["status"] = "ok" if pr.success else "failed"
            if pr.optimization is not None:
                pj["final_cost"] = pr.optimization.core.final_cost
            if pr.success:
                any_success = True
                context.stereo_results[pair_cfg.pair_id] = pr.optimization
            else:
                all_success = False
            artifact = {
                "initial_guess": {
                    "c_se3_r": [_pose_json(m) for m in pr.initial_guess.c_se3_r],
                    "r_se3_t": [_pose_json(m) for m in pr.initial_guess.r_se3_t],
                },
                "views": pj.get("views", []),
            }
            if pr.optimization is not None:
                artifact["optimization"] = {
                    "success": pr.optimization.core.success,
                    "final_cost": pr.optimization.core.final_cost,
                    "report": pr.optimization.core.report,
                    "cameras": [c.tolist() for c in pr.optimization.cameras],
                    "c_se3_r": [_pose_json(m) for m in pr.optimization.c_se3_r],
                    "r_se3_t": [_pose_json(m) for m in pr.optimization.r_se3_t],
                }
                artifact["final_cost"] = pr.optimization.core.final_cost
            stereo_artifacts["pairs"][pair_cfg.pair_id] = artifact

        result.summary["pairs"] = pairs_summary
        result.summary["status"], result.success = _aggregate(any_success, all_success)
        return result


def _aggregate(any_success: bool, all_success: bool):
    if any_success and all_success:
        return "ok", True
    if any_success:
        return "partial_success", False
    return "failed", False
