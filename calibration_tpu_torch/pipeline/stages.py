"""Pipeline stages (port of ``calibration_tpu/pipeline/stages.py``: the
intrinsics, stereo and hand-eye stages; the bundle stage comes with its
slice).

Status strings, summary structure, artifact layout and the
ok/partial_success/failed aggregation rules mirror the reference so report
consumers see the same JSON.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..io import jsonio
from . import fleet
from .facades.extrinsics import StereoCalibrationFacade
from .facades.intrinsics import PlanarIntrinsicCalibrationFacade
from .pipeline import CalibrationStage, PipelineContext, PipelineStageResult
from .planar_utils import build_sensor_index, find_camera_config, make_planar_arrays
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


class HandEyeCalibrationStage(CalibrationStage):
    """handeye_stage.cpp:34-224, on ``device``. The reference solves per rig
    and sensor serially (and one planar pose per view); here every view's
    pose and every sensor's AX = XB solve run as one batched call per shape
    bucket (``fleet.planar_handeye_fleet``), with the reference's
    per-sensor results and statuses. A failing batched solve raises."""

    def __init__(self, device):
        self.device = device

    def name(self) -> str:
        return "hand_eye"

    def run(self, context: PipelineContext) -> PipelineStageResult:
        result = PipelineStageResult(name=self.name())
        if not context.intrinsic_results:
            result.summary["status"] = "waiting_for_intrinsic_stage"
            return result
        if not context.has_handeye_config():
            result.summary["status"] = "missing_config"
            return result
        cfg = context.handeye_config()
        if not cfg.rigs:
            result.summary["status"] = "no_rigs_configured"
            return result

        sensor_index = build_sensor_index(context.dataset.planar_cameras)
        context.handeye_results.clear()
        he_artifacts = context.artifacts.setdefault("hand_eye", {})

        # walk rigs, sensors and views; the device work is deferred
        records = []  # one per (rig, sensor)
        rigs = []  # (rig_json, sensors_json)
        for rig in cfg.rigs:
            rig_json = {"rig_id": rig.rig_id, "sensor_count": len(rig.sensors), "min_angle_deg": rig.min_angle_deg}
            rig_artifact = he_artifacts.setdefault(rig.rig_id, {})
            rig_artifact["min_angle_deg"] = rig.min_angle_deg
            rig_artifact["options"] = jsonio.to_jsonable(rig.options)
            sensors_artifact = rig_artifact.setdefault("sensors", {})
            sensors_json: List[dict] = []
            rigs.append((rig_json, sensors_json))

            for sensor_id in rig.sensors:
                sj = {
                    "sensor_id": sensor_id,
                    "requested_observations": len(rig.observations),
                    "min_angle_deg": rig.min_angle_deg,
                }
                rec = {
                    "rig": rig, "sensor_id": sensor_id, "sj": sj, "sensors_json": sensors_json,
                    "sensors_artifact": sensors_artifact, "bases": [], "views_obj": [], "views_uv": [],
                    "kmtx": None, "solve": False,
                }
                records.append(rec)
                intr = context.intrinsic_results.get(sensor_id)
                if intr is None:
                    sj["status"] = "missing_intrinsics"
                    continue
                det_index = sensor_index.get(sensor_id)
                if det_index is None:
                    sj["status"] = "missing_detections"
                    continue

                kmtx = np.asarray(intr.refine_result.camera[:5])
                view_reports = []
                for view_cfg in rig.observations:
                    vj = {}
                    if view_cfg.view_id:
                        vj["id"] = view_cfg.view_id
                    vj["base_pose"] = _pose_json(view_cfg.base_se3_gripper)
                    view_reports.append(vj)
                    fname = view_cfg.images.get(sensor_id)
                    if fname is None:
                        vj["status"] = "missing_image_reference"
                        continue
                    img = det_index.image_lookup.get(fname)
                    if img is None:
                        vj["status"] = "image_not_in_dataset"
                        continue
                    obj, uv = make_planar_arrays(img)
                    vj["points"] = obj.shape[0]
                    if obj.shape[0] < 4:
                        vj["status"] = "insufficient_points"
                        continue
                    rec["bases"].append(np.asarray(view_cfg.base_se3_gripper))
                    rec["views_obj"].append(obj)
                    rec["views_uv"].append(uv)
                    rec["kmtx"] = kmtx
                    vj["status"] = "ok"

                used = len(rec["bases"])
                sj["used_observations"] = used
                sj["views"] = view_reports
                if used < 2:
                    sj["status"] = "no_observations" if not used else "insufficient_observations"
                else:
                    rec["solve"] = True

        # planar poses + AX = XB solves, one batched call per bucket
        he_recs = [rec for rec in records if rec["solve"]]
        jobs = [
            (rec["views_obj"], rec["views_uv"], rec["kmtx"], np.stack(rec["bases"]),
             rec["rig"].min_angle_deg, rec["rig"].options)
            for rec in he_recs
        ]
        he_results = fleet.planar_handeye_fleet(jobs, self.device) if jobs else []

        # reports and statuses, in submission order
        for rec, he in zip(he_recs, he_results):
            sj = rec["sj"]
            sj["status"] = "ok" if he.core.success else "optimization_failed"
            sj["success"] = he.core.success
            sj["final_cost"] = he.core.final_cost
            sj["report"] = he.core.report
            sj["g_se3_c"] = _pose_json(he.g_se3_c)
            if he.core.covariance is not None:
                sj["covariance"] = he.core.covariance.tolist()
            if he.core.success:
                context.handeye_results.setdefault(rec["rig"].rig_id, {})[rec["sensor_id"]] = he

        for rec in records:
            rec["sensors_json"].append(rec["sj"])
            rec["sensors_artifact"][rec["sensor_id"]] = rec["sj"]

        overall, any_success = True, False
        rigs_json = []
        for rig_json, sensors_json in rigs:
            # per-rig success from THIS rig's sensor reports, never from
            # context.handeye_results, whose rig_id key another rig with a
            # duplicate (e.g. default-empty) rig_id may have filled
            rig_any = any(sj.get("status") == "ok" for sj in sensors_json)
            rig_success = all(sj.get("status") == "ok" for sj in sensors_json) and bool(sensors_json)
            if rig_any and rig_success:
                rig_json["status"] = "ok"
                any_success = True
            elif rig_any:
                rig_json["status"] = "partial_success"
                any_success = True
                overall = False
            else:
                rig_json["status"] = "failed"
                overall = False
            rig_json["sensor_reports"] = sensors_json
            rigs_json.append(rig_json)

        result.summary["rigs"] = rigs_json
        result.summary["status"], result.success = _aggregate(any_success, overall)
        return result
