"""Pipeline stages (port of ``calibration_tpu/pipeline/stages.py``: the
intrinsics, stereo, hand-eye and bundle stages).

Status strings, summary structure, artifact layout and the
ok/partial_success/failed aggregation rules mirror the reference so report
consumers see the same JSON.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..io import jsonio
from . import fleet
from .facades.extrinsics import StereoCalibrationFacade
from .facades.intrinsics import PlanarIntrinsicCalibrationFacade
from .pipeline import CalibrationStage, PipelineContext, PipelineStageResult
from .planar_utils import build_sensor_index, find_camera_config, find_handeye_rig, make_planar_arrays, pad_views
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


class BundleAdjustmentStage(CalibrationStage):
    """bundle_stage.cpp:8-169 + detail/bundle_utils.cpp, on ``device``.

    The reference adjusts rig by rig; here every rig's device work runs as
    batched calls per shape bucket. When no rig needs a DLT hand-eye seed,
    planar poses, the averaged target init and the bundle LM are one call
    (``fleet.bundle_fused_fleet``); otherwise they are staged: planar poses,
    DLT seeds, target averages, then the bundle LM (``fleet.bundle_fleet``).
    Statuses and artifacts are the reference's. A failing batched solve
    raises: the port has none of the reference's fallbacks to a staged or
    serial re-solve, so the per-rig ``optimization_error`` status, which
    only the last of them produces, does not occur here.
    """

    def __init__(self, device):
        self.device = device

    def name(self) -> str:
        return "bundle"

    def run(self, context: PipelineContext) -> PipelineStageResult:
        result = PipelineStageResult(name=self.name())
        if not context.intrinsic_results:
            result.summary["status"] = "waiting_for_intrinsic_stage"
            return result
        if not context.has_bundle_config():
            result.summary["status"] = "missing_config"
            return result
        cfg = context.bundle_config()
        if not cfg.rigs:
            result.summary["status"] = "no_rigs_configured"
            return result

        sensor_index = build_sensor_index(context.dataset.planar_cameras)
        context.bundle_results.clear()
        bundle_artifacts = context.artifacts.setdefault("bundle", {})
        he_cfg = context.handeye_config() if context.has_handeye_config() else None
        overall, any_success = True, False

        # walk rigs, sensors and views; the device work is deferred
        pose_jobs: List[tuple] = []  # (obj, uv, kmtx)
        recs = []  # one per rig, in config order
        for rig in cfg.rigs:
            rig_json = {"rig_id": rig.rig_id, "sensor_count": len(rig.sensors), "min_angle_deg": rig.min_angle_deg}
            rec = {"rig": rig, "json": rig_json, "solve": False}
            recs.append(rec)
            # the hand-eye rig's observations when the bundle rig has none
            # (bundle_utils.cpp:30-44)
            observations = rig.observations
            if not observations and he_cfg is not None:
                he_rig = find_handeye_rig(he_cfg, rig.rig_id)
                if he_rig is not None and he_rig.observations:
                    observations = he_rig.observations
            requested = len(observations)
            if not observations:
                rig_json.update(status="no_observations", observations={"requested": requested, "used": 0})
                overall = False
                continue

            rig_artifact = bundle_artifacts.setdefault(rig.rig_id, {})
            rig_artifact["options"] = jsonio.to_jsonable(rig.options)
            rig_artifact["min_angle_deg"] = rig.min_angle_deg
            rec["artifact"] = rig_artifact

            if any(s not in context.intrinsic_results for s in rig.sensors):
                rig_json.update(status="missing_intrinsics", observations={"requested": requested, "used": 0})
                overall = False
                continue
            cameras = np.stack([context.intrinsic_results[s].refine_result.camera for s in rig.sensors])

            obs_views, obs_bg, obs_cam_idx = [], [], []
            accum_base: Dict[int, List] = {i: [] for i in range(len(rig.sensors))}
            accum_pose_idx: Dict[int, List] = {i: [] for i in range(len(rig.sensors))}
            views_json = []
            for view_cfg in observations:
                vj = {}
                if view_cfg.view_id:
                    vj["id"] = view_cfg.view_id
                vj["base_pose"] = _pose_json(view_cfg.base_se3_gripper)
                sensor_reports = []
                used = False
                for sidx, sensor_id in enumerate(rig.sensors):
                    se = {"sensor_id": sensor_id}
                    sensor_reports.append(se)
                    fname = view_cfg.images.get(sensor_id)
                    if fname is None:
                        se["status"] = "missing_image_reference"
                        continue
                    det_index = sensor_index.get(sensor_id)
                    if det_index is None:
                        se["status"] = "missing_detections"
                        continue
                    img = det_index.image_lookup.get(fname)
                    if img is None:
                        se.update(status="image_not_in_dataset", image=fname)
                        continue
                    obj, uv = make_planar_arrays(img)
                    se.update(image=fname, points=obj.shape[0])
                    if obj.shape[0] < 4:
                        se["status"] = "insufficient_points"
                        continue
                    base = np.asarray(view_cfg.base_se3_gripper)
                    obs_views.append((obj, uv))
                    obs_bg.append(base)
                    obs_cam_idx.append(sidx)
                    accum_base[sidx].append(base)
                    accum_pose_idx[sidx].append(len(pose_jobs))
                    pose_jobs.append((obj, uv, np.asarray(cameras[sidx][:5])))
                    se["status"] = "ok"
                    used = True
                vj["sensors"] = sensor_reports
                vj["used"] = used
                views_json.append(vj)

            rig_json["observations"] = {"requested": requested, "used": len(obs_views)}
            rig_json["views"] = views_json
            if not obs_views:
                rig_json["status"] = "no_valid_observations"
                overall = False
                continue
            rec.update(
                solve=True, cameras=cameras, obs_views=obs_views, obs_bg=obs_bg, obs_cam_idx=obs_cam_idx,
                accum_base=accum_base, accum_pose_idx=accum_pose_idx, views_json=views_json,
            )

        # hand-eye init and target sources (bundle_utils.cpp:148-237), from
        # what the host knows; DLT seeds are deferred device work
        solve_recs = [rec for rec in recs if rec["solve"]]
        any_dlt = False
        for rec in solve_recs:
            rig = rec["rig"]
            he_init = np.tile(np.eye(4), (len(rig.sensors), 1, 1))
            he_report = []
            rec["he_failed"] = False
            rec["dlt_sidx"] = []
            rig_he = context.handeye_results.get(rig.rig_id, {})
            for sidx, sensor_id in enumerate(rig.sensors):
                entry = {"sensor_id": sensor_id, "source": "identity"}
                he = rig_he.get(sensor_id)
                if he is not None and he.core.success:
                    he_init[sidx] = he.g_se3_c
                    entry.update(source="handeye", success=True)
                elif len(rec["accum_pose_idx"][sidx]) >= 2:
                    entry["source"] = "dlt"
                    rec["dlt_sidx"].append((sidx, entry))
                    any_dlt = True
                else:
                    entry.update(success=False, error="insufficient_observations")
                    rec["he_failed"] = True
                he_report.append(entry)
            rec["json"]["handeye_initialization"] = he_report
            rec.update(he_init=he_init, he_report=he_report)
            # config target, else the average of b X c (always possible
            # here: a rig that solves has observations)
            if rig.initial_target is not None:
                rec.update(target=np.asarray(rig.initial_target), target_source="config")
            else:
                rec["target_source"] = "estimated"
            if rec["he_failed"] and rig.initial_target is None:
                overall = False

        if solve_recs and not any_dlt:
            bundle_results = self._fused(solve_recs)
        elif solve_recs:
            bundle_results, dlt_failed = self._staged(solve_recs, pose_jobs)
            overall = overall and not dlt_failed
        else:
            bundle_results = []

        # reports, in rig order
        for rec, br in zip(solve_recs, bundle_results):
            rig, rig_json, rig_artifact = rec["rig"], rec["json"], rec["artifact"]
            rig_json["initial_target_source"] = rec["target_source"]
            rig_artifact["initial_hand_eye"] = rec["he_report"]
            rig_artifact["initial_target"] = _pose_json(rec["target"])
            result_json = {
                "success": br.core.success,
                "final_cost": br.core.final_cost,
                "report": br.core.report,
                "b_se3_t": _pose_json(br.b_se3_t),
                "g_se3_c": [_pose_json(m) for m in br.g_se3_c],
                "cameras": [c.tolist() for c in br.cameras],
            }
            if br.core.covariance is not None:
                result_json["covariance"] = br.core.covariance.tolist()
            rig_artifact["result"] = result_json
            rig_artifact["views"] = rec["views_json"]
            rig_json["success"] = br.core.success
            rig_json["final_cost"] = br.core.final_cost
            if br.core.success:
                rig_json["status"] = "ok"
                any_success = True
                context.bundle_results[rig.rig_id] = br
            else:
                rig_json["status"] = "optimization_failed"
                overall = False

        result.summary["rigs"] = [rec["json"] for rec in recs]
        result.summary["status"], result.success = _aggregate(any_success, overall)
        return result

    def _fused(self, solve_recs) -> list:
        """Every hand-eye init is known: planar poses, the target init and
        the bundle LM in one batched call per bucket."""
        jobs = []
        for rec in solve_recs:
            obj, uv, mask = pad_views(rec["obs_views"])
            cam_idx = np.asarray(rec["obs_cam_idx"])
            given = rec["target_source"] == "config"
            jobs.append(fleet.FusedBundleJob(
                obj=obj, uv=uv, mask=mask, kmtx=rec["cameras"][cam_idx][:, :5], bg=np.stack(rec["obs_bg"]),
                cam_idx=cam_idx, cameras=rec["cameras"], he_init=rec["he_init"],
                target_given=rec["target"] if given else np.eye(4), use_given_target=given, opts=rec["rig"].options,
            ))
        results = []
        for rec, (br, tgt0) in zip(solve_recs, fleet.bundle_fused_fleet(jobs, self.device)):
            rec["target"] = tgt0
            results.append(br)
        return results

    def _staged(self, solve_recs, pose_jobs):
        """Planar poses, DLT seeds, target averages, then the bundle LM,
        one batched call each. Returns (bundle results, whether a DLT seed
        failed on a rig without a config target)."""
        poses = fleet.planar_pose_fleet(pose_jobs, self.device) if pose_jobs else []
        dlt_jobs, dlt_slots = [], []
        for rec in solve_recs:
            rec["accum_cam"] = {sidx: [poses[i] for i in idx] for sidx, idx in rec["accum_pose_idx"].items()}
            for sidx, entry in rec["dlt_sidx"]:
                dlt_jobs.append((np.stack(rec["accum_base"][sidx]), np.stack(rec["accum_cam"][sidx]),
                                 rec["rig"].min_angle_deg))
                dlt_slots.append((rec, sidx, entry))
        dlt_failed = False
        for (rec, sidx, entry), (pose, ok) in zip(dlt_slots, fleet.handeye_dlt_fleet(dlt_jobs, self.device)):
            rec["he_init"][sidx] = pose
            entry["success"] = ok
            if not ok:
                rec["he_failed"] = True
                dlt_failed = dlt_failed or rec["rig"].initial_target is None

        estimated = [rec for rec in solve_recs if rec["target_source"] == "estimated"]
        groups = [
            [b @ rec["he_init"][sidx] @ c
             for sidx in range(len(rec["rig"].sensors))
             for b, c in zip(rec["accum_base"][sidx], rec["accum_cam"][sidx])]
            for rec in estimated
        ]
        for rec, avg in zip(estimated, fleet.average_isometries_fleet(groups, self.device)):
            rec["target"] = avg

        jobs = []
        for rec in solve_recs:
            obj, uv, mask = pad_views(rec["obs_views"])
            jobs.append(fleet.BundleJob(
                obj=obj, uv=uv, bg=np.stack(rec["obs_bg"]), cam_idx=np.asarray(rec["obs_cam_idx"]),
                cameras=rec["cameras"], he_init=rec["he_init"], target=rec["target"], mask=mask,
                opts=rec["rig"].options,
            ))
        return fleet.bundle_fleet(jobs, self.device), dlt_failed
