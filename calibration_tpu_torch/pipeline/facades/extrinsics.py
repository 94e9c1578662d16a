"""Stereo / multi-camera extrinsics facades (port of
``calibration_tpu/pipeline/facades/extrinsics.py``).

View matching by filename, >= 4 points each; DLT seed through coordinates
normalized with K; then the joint LM refinement. Each facade works on one
explicit torch device. ``calibrate`` solves one pair or rig;
``calibrate_many`` runs the host walk per item and then one batched solve
per shape bucket (``pipeline/fleet.py``). A failing batched solve raises:
no serial re-solve hides it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ...optim import ExtrinsicOptimizationResult, ExtrinsicOptions
from .. import fleet
from ..dataset import PlanarDetections
from ..planar_utils import make_planar_arrays
from .intrinsics import IntrinsicCalibrationOutputs


@dataclasses.dataclass
class StereoViewSelection:
    """facades/extrinsics.h:18-21."""

    reference_image: str = ""
    target_image: str = ""


@dataclasses.dataclass
class StereoPairConfig:
    """facades/extrinsics.h:23-29."""

    pair_id: str = ""
    reference_sensor: str = ""
    target_sensor: str = ""
    views: List[StereoViewSelection] = dataclasses.field(default_factory=list)
    options: ExtrinsicOptions = dataclasses.field(default_factory=ExtrinsicOptions)


@dataclasses.dataclass
class StereoCalibrationConfig:
    """facades/extrinsics.h:31-33."""

    pairs: List[StereoPairConfig] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StereoCalibrationViewSummary:
    """facades/extrinsics.h:35-41."""

    reference_image: str = ""
    target_image: str = ""
    reference_points: int = 0
    target_points: int = 0
    status: str = ""


@dataclasses.dataclass
class ExtrinsicPosesOut:
    c_se3_r: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 4, 4)))
    r_se3_t: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((0, 4, 4)))


@dataclasses.dataclass
class StereoCalibrationRunResult:
    """facades/extrinsics.h:43-50."""

    success: bool = False
    requested_views: int = 0
    used_views: int = 0
    view_summaries: List[StereoCalibrationViewSummary] = dataclasses.field(default_factory=list)
    initial_guess: ExtrinsicPosesOut = dataclasses.field(default_factory=ExtrinsicPosesOut)
    optimization: Optional[ExtrinsicOptimizationResult] = None


def _pack_multicam(views_raw: List[List[tuple]]) -> tuple:
    """ragged [view][cam] -> padded (V, C, N, 2) x2 + (V, C, N) mask."""
    v = len(views_raw)
    c = len(views_raw[0])
    n = max(max(o.shape[0] for o, _ in view) for view in views_raw)
    obj = np.zeros((v, c, n, 2))
    uv = np.zeros((v, c, n, 2))
    mask = np.zeros((v, c, n), bool)
    for vi, view in enumerate(views_raw):
        for ci, (o, u) in enumerate(view):
            k = o.shape[0]
            obj[vi, ci, :k] = o
            uv[vi, ci, :k] = u
            mask[vi, ci, :k] = True
    return obj, uv, mask


def _run_extrinsic_estimation(views_raw, cameras, options: ExtrinsicOptions, device):
    """DLT seed + joint LM for one pair or rig (facades/extrinsics.cpp:
    120-133): a fleet of one, so the serial and fleet paths share every
    line of the solve."""
    obj, uv, mask = _pack_multicam(views_raw)
    job = fleet.ExtrinsicsJob(obj=obj, uv=uv, mask=mask, cameras=cameras, opts=options)
    (init_c, init_r), optimization = fleet.extrinsics_fleet([job], device)[0]
    return ExtrinsicPosesOut(init_c, init_r), optimization


def _collect_stereo_views(
    cfg: StereoPairConfig,
    reference_detections: PlanarDetections,
    target_detections: PlanarDetections,
    reference_intrinsics: IntrinsicCalibrationOutputs,
    target_intrinsics: IntrinsicCalibrationOutputs,
):
    """The stereo host walk (facades/extrinsics.cpp:39-89): view matching
    by filename, per-view status summaries, >= 4-point gating. Both
    ``calibrate`` and ``calibrate_many`` consume it.

    Returns (result with summaries, views_raw, cameras); cameras is None
    when no view survived."""
    result = StereoCalibrationRunResult(requested_views=len(cfg.views))
    if reference_intrinsics.refine_result is None or target_intrinsics.refine_result is None:
        raise RuntimeError("StereoCalibrationFacade: camera intrinsics are not available.")

    ref_lookup = {img.file: img for img in reference_detections.images}
    tgt_lookup = {img.file: img for img in target_detections.images}

    views_raw = []
    for sel in cfg.views:
        summary = StereoCalibrationViewSummary(sel.reference_image, sel.target_image)
        ref_img = ref_lookup.get(sel.reference_image)
        tgt_img = tgt_lookup.get(sel.target_image)
        if ref_img is None:
            summary.status = "missing_reference_image"
            result.view_summaries.append(summary)
            continue
        if tgt_img is None:
            summary.status = "missing_target_image"
            result.view_summaries.append(summary)
            continue
        ref_view = make_planar_arrays(ref_img)
        tgt_view = make_planar_arrays(tgt_img)
        summary.reference_points = ref_view[0].shape[0]
        summary.target_points = tgt_view[0].shape[0]
        if summary.reference_points < 4 or summary.target_points < 4:
            summary.status = "insufficient_points"
            result.view_summaries.append(summary)
            continue
        summary.status = "ok"
        result.view_summaries.append(summary)
        views_raw.append([ref_view, tgt_view])

    result.used_views = len(views_raw)
    if not views_raw:
        return result, views_raw, None
    cameras = np.stack(
        [reference_intrinsics.refine_result.camera, target_intrinsics.refine_result.camera]
    )
    return result, views_raw, cameras


def _fleet_calibrate_many(items, collect, device):
    """Shared fleet driver for both extrinsics facades: the host walk
    (``collect``, returning (result, views_raw, cameras)) per item, the
    survivors packed into ExtrinsicsJobs and solved in one batched solve
    per shape bucket, the optimizations spliced back in item order. A
    host-walk exception is that item's result (stereo_stage.cpp:141-146
    per-pair isolation); an exception of the batched solve propagates."""
    results: list = [None] * len(items)
    jobs, job_slots = [], []
    for i, item in enumerate(items):
        try:
            result, views_raw, cameras = collect(*item)
            results[i] = result
            if cameras is None:
                continue
            obj, uv, mask = _pack_multicam(views_raw)
            jobs.append(fleet.ExtrinsicsJob(obj=obj, uv=uv, mask=mask, cameras=cameras, opts=item[0].options))
            job_slots.append(i)
        except Exception as ex:  # noqa: BLE001 — per-pair/per-rig isolation
            results[i] = ex

    solved = fleet.extrinsics_fleet(jobs, device) if jobs else []
    for slot, ((init_c, init_r), opt) in zip(job_slots, solved):
        result = results[slot]
        result.initial_guess = ExtrinsicPosesOut(init_c, init_r)
        result.optimization = opt
        result.success = opt.core.success
    return results


class StereoCalibrationFacade:
    """facades/extrinsics.cpp:91-134, on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def calibrate(
        self,
        cfg: StereoPairConfig,
        reference_detections: PlanarDetections,
        target_detections: PlanarDetections,
        reference_intrinsics: IntrinsicCalibrationOutputs,
        target_intrinsics: IntrinsicCalibrationOutputs,
    ) -> StereoCalibrationRunResult:
        result, views_raw, cameras = _collect_stereo_views(
            cfg, reference_detections, target_detections, reference_intrinsics, target_intrinsics,
        )
        if cameras is None:
            result.success = False
            return result
        result.initial_guess, result.optimization = _run_extrinsic_estimation(
            views_raw, cameras, cfg.options, self.device
        )
        result.success = result.optimization.core.success
        return result

    def calibrate_many(self, items) -> list:
        """Fleet variant of ``calibrate``: one batched DLT + LM solve per
        (V, C, N, options) bucket instead of one per pair.

        items: sequence of ``calibrate`` argument tuples (cfg, ref_det,
        tgt_det, ref_intr, tgt_intr). Returns one StereoCalibrationRunResult
        (or the Exception its host walk raised) per item, in order."""
        return _fleet_calibrate_many(items, _collect_stereo_views, self.device)


@dataclasses.dataclass
class MultiCameraViewSelection:
    """facades/extrinsics.h:63-66."""

    images: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MultiCameraRigConfig:
    """facades/extrinsics.h:68-73."""

    rig_id: str = ""
    sensors: List[str] = dataclasses.field(default_factory=list)
    views: List[MultiCameraViewSelection] = dataclasses.field(default_factory=list)
    options: ExtrinsicOptions = dataclasses.field(default_factory=ExtrinsicOptions)


@dataclasses.dataclass
class MultiCameraCalibrationRunResult:
    """facades/extrinsics.h:75-82."""

    success: bool = False
    requested_views: int = 0
    used_views: int = 0
    sensors: List[str] = dataclasses.field(default_factory=list)
    initial_guess: ExtrinsicPosesOut = dataclasses.field(default_factory=ExtrinsicPosesOut)
    optimization: Optional[ExtrinsicOptimizationResult] = None


def _collect_multicam_views(
    cfg: MultiCameraRigConfig,
    detections_by_sensor: Dict[str, PlanarDetections],
    intrinsics_by_sensor: Dict[str, IntrinsicCalibrationOutputs],
):
    """The multicam host walk (facades/extrinsics.cpp:137-175):
    all-sensors-present view matching, >= 4-point gating. Shared by
    ``calibrate`` and ``calibrate_many``.

    Returns (result, views_raw, cameras); cameras is None when no view
    survived."""
    result = MultiCameraCalibrationRunResult(requested_views=len(cfg.views), sensors=list(cfg.sensors))
    for sid in cfg.sensors:
        intr = intrinsics_by_sensor.get(sid)
        if intr is None or intr.refine_result is None:
            raise RuntimeError(
                f"MultiCameraCalibrationFacade: intrinsics not available for sensor: {sid}"
            )

    lookup = {sid: {img.file: img for img in det.images} for sid, det in detections_by_sensor.items()}
    views_raw = []
    for sel in cfg.views:
        multi = []
        for sid in cfg.sensors:
            fname = sel.images.get(sid)
            img = lookup.get(sid, {}).get(fname) if fname else None
            if img is None:
                break
            view = make_planar_arrays(img)
            if view[0].shape[0] < 4:
                break
            multi.append(view)
        else:
            views_raw.append(multi)

    result.used_views = len(views_raw)
    if not views_raw:
        return result, views_raw, None
    cameras = np.stack([intrinsics_by_sensor[sid].refine_result.camera for sid in cfg.sensors])
    return result, views_raw, cameras


class MultiCameraCalibrationFacade:
    """facades/extrinsics.cpp:137-229, on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def calibrate(
        self,
        cfg: MultiCameraRigConfig,
        detections_by_sensor: Dict[str, PlanarDetections],
        intrinsics_by_sensor: Dict[str, IntrinsicCalibrationOutputs],
    ) -> MultiCameraCalibrationRunResult:
        result, views_raw, cameras = _collect_multicam_views(cfg, detections_by_sensor, intrinsics_by_sensor)
        if cameras is None:
            result.success = False
            return result
        result.initial_guess, result.optimization = _run_extrinsic_estimation(
            views_raw, cameras, cfg.options, self.device
        )
        result.success = result.optimization.core.success
        return result

    def calibrate_many(self, items) -> list:
        """Fleet variant of ``calibrate``: one batched DLT + LM solve per
        (V, C, N, options) bucket instead of one per rig.

        items: sequence of ``calibrate`` argument tuples (cfg,
        detections_by_sensor, intrinsics_by_sensor). Returns one
        MultiCameraCalibrationRunResult (or the Exception its host walk
        raised) per item, in order."""
        return _fleet_calibrate_many(items, _collect_multicam_views, self.device)
