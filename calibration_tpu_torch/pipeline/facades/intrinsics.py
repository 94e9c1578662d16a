"""Planar intrinsics calibration facade (port of
``calibration_tpu/pipeline/facades/intrinsics.py``).

Flow per sensor: min-corner view gating -> optional RANSAC homography
prefilter -> linear Zhang estimate (warnings counted) -> per-view pose init
-> LM refinement with zero-initialised distortion, falling back to the
linear K when the refine does not converge.

The facade works on one explicit torch device. ``calibrate`` runs one
sensor (a B = 1 solve); ``calibrate_many`` runs a fleet: ONE batched RANSAC
prefilter over every real view of every sensor that shares a point bucket,
then one ``intrinsics_facade_batch`` per (shape, bounds, model) group and
one host transfer per group. ``CameraConfig.model`` picks the registry
model (pinhole or Scheimpflug); an unknown name gives that sensor an
exception, as every per-sensor failure does. The fleet's QA recheck is the
pinhole model's, as in the reference: a Scheimpflug sensor gets none.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...convert import to_numpy
from ...io import jsonio
from ...models import CalibrationBounds
from ...models.registry import get_model
from ...ops import intrinsics_linear, planarpose
from ...ops import ransac as ransac_mod
from ...optim import IntrinsicsOptimOptions, IntrinsicsOptimizationResult, optimize_intrinsics
from ...optim.core import OptimResult, TerminationType, brief_report
from ...parallel.batched import intrinsics_facade_batch
from ...utils import profiling
from ...utils.lazy import BatchFetcher, LazyDeviceArray
from ..dataset import PlanarDetections
from ..planar_utils import bucket_points, bucket_views, make_planar_arrays, pad_views


@dataclasses.dataclass
class RansacConfig:
    """JSON-facing RansacOptions (ransac.h:22-29)."""

    max_iters: int = 1000
    thresh: float = 2.0
    min_inliers: int = 12
    confidence: float = 0.99
    seed: int = 1234567
    refit_on_inliers: bool = True
    round_size: int = 128

    def to_options(self) -> ransac_mod.RansacOptions:
        return ransac_mod.RansacOptions(
            max_iters=self.max_iters, thresh=self.thresh, min_inliers=self.min_inliers,
            confidence=self.confidence, seed=self.seed, refit_on_inliers=self.refit_on_inliers,
            round_size=self.round_size,
        )


@dataclasses.dataclass
class IntrinsicsEstimConfig:
    """IntrinsicsEstimOptions (estimation/linear/intrinsics.h:26-31)."""

    bounds: Optional[CalibrationBounds] = None
    homography_ransac: Optional[RansacConfig] = None
    use_skew: bool = False


@dataclasses.dataclass
class IntrinsicCalibrationOptions:
    """facades/intrinsics.h:25-30."""

    optim_options: IntrinsicsOptimOptions = dataclasses.field(default_factory=IntrinsicsOptimOptions)
    estim_options: IntrinsicsEstimConfig = dataclasses.field(default_factory=IntrinsicsEstimConfig)
    min_corners_per_view: int = 80
    refine: bool = True


@dataclasses.dataclass
class CameraConfig:
    """facades/intrinsics.h:32-36."""

    camera_id: str = ""
    model: str = "pinhole_brown_conrady"
    image_size: Optional[List[int]] = None


@dataclasses.dataclass
class IntrinsicCalibrationConfig:
    """facades/intrinsics.h:41-45."""

    algorithm: str = "planar"
    options: IntrinsicCalibrationOptions = dataclasses.field(
        default_factory=IntrinsicCalibrationOptions
    )
    cameras: List[CameraConfig] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ActiveView:
    """facades/intrinsics.h:47-50."""

    source_image: str = ""
    corner_count: int = 0


@dataclasses.dataclass
class IntrinsicCalibrationOutputs:
    """facades/intrinsics.h:52-64, plus the per-view linear-stage homography
    diagnostics (the DLT homography, its symmetric transfer RMS, validity,
    and the inlier mask used downstream, after the RANSAC prefilter when it
    is on) and the fleet path's QA: per-view reprojection RMS recomputed
    independently of the solver through the float32 projection-residual
    kernel; ``rms_check_warnings`` counts views where the two disagree by
    more than 5e-3 px."""

    linear_kmtx: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(5))
    linear_view_indices: List[int] = dataclasses.field(default_factory=list)
    refine_result: Optional[IntrinsicsOptimizationResult] = None
    active_views: List[ActiveView] = dataclasses.field(default_factory=list)
    total_input_views: int = 0
    accepted_views: int = 0
    used_views: int = 0
    total_points_used: int = 0
    min_corner_threshold: int = 0
    invalid_k_warnings: int = 0
    pose_warnings: int = 0
    view_homographies: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3, 3))
    )
    view_h_rms: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    view_h_ok: List[bool] = dataclasses.field(default_factory=list)
    view_inlier_masks: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0), bool)
    )
    view_inlier_counts: List[int] = dataclasses.field(default_factory=list)
    view_rms_check: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    rms_check_warnings: int = 0

    @property
    def camera(self) -> np.ndarray:
        """Refined flat intrinsics (model packing; pinhole = 10)."""
        return self.refine_result.camera


def bounds_from_image_size(image_size) -> CalibrationBounds:
    """Heuristic parameter box from image dims (facades/intrinsics.cpp:61-78)."""
    width, height = float(image_size[0]), float(image_size[1])
    short_side, long_side = min(width, height), max(width, height)
    skew_limit = 0.05 * long_side
    return CalibrationBounds(
        fx_min=max(1.0, 0.25 * short_side), fx_max=float(np.finfo(np.float64).max),
        fy_min=max(1.0, 0.25 * short_side), fy_max=float(np.finfo(np.float64).max),
        cx_min=0.05 * width, cx_max=0.95 * width,
        cy_min=0.05 * height, cy_max=0.95 * height,
        skew_min=-skew_limit, skew_max=skew_limit,
    )


def collect_planar_views(
    detections: PlanarDetections, opts: IntrinsicCalibrationOptions
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[ActiveView]]:
    """Min-corner gating (facades/intrinsics.cpp:38-59). Returns padded
    (obj, uv, mask) + active view descriptors."""
    raw = []
    active: List[ActiveView] = []
    for img in detections.images:
        if img.num_points() < opts.min_corners_per_view:
            continue
        raw.append(make_planar_arrays(img))
        active.append(ActiveView(img.file, img.num_points()))
    obj, uv, mask = pad_views(raw)
    return obj, uv, mask, active


@dataclasses.dataclass
class _PreparedProblem:
    """Host-side prepared inputs for one sensor (gating + bucketing done)."""

    out: IntrinsicCalibrationOutputs
    obj: np.ndarray  # (V_pad, N_pad, 2)
    uv: np.ndarray
    mask: np.ndarray  # (V_pad, N_pad), after the RANSAC prefilter when it is on
    view_valid: np.ndarray  # (V_pad,) bool
    bounds: Optional[CalibrationBounds]
    v_real: int
    active: List[ActiveView]


def _fill_linear_outputs(out, p, kmtx, k_ok, h_ok, homographies, view_rms, pose_ok):
    """Linear-stage diagnostics shared by the serial and fleet paths
    (warning counts + per-view homography payload). Returns whether the
    linear K was valid; on False the caller reports the failure message."""
    out.pose_warnings = int(np.sum(~np.asarray(pose_ok)[p.view_valid]))
    out.invalid_k_warnings = 0 if k_ok else 1
    if not k_ok:
        return False
    h_ok = np.asarray(h_ok)
    out.linear_kmtx = np.asarray(kmtx)
    out.linear_view_indices = [int(v) for v in np.where(h_ok)[0]]
    out.view_homographies = np.asarray(homographies)[: p.v_real]
    out.view_h_rms = np.asarray(view_rms)[: p.v_real]
    out.view_h_ok = [bool(b) for b in h_ok[: p.v_real]]
    out.view_inlier_masks = np.asarray(p.mask, bool)[: p.v_real]
    out.view_inlier_counts = [int(c) for c in out.view_inlier_masks.sum(axis=-1)]
    return True


def _linear_fallback_camera(kmtx, zero_skew: bool, param_count: int) -> np.ndarray:
    """Refine-failure fallback: the linear K with zero distortion
    (facades/intrinsics.cpp:132-136), skew pinned when nobody asked for it."""
    kmtx_init = np.asarray(kmtx, np.float64).copy()
    if zero_skew:
        kmtx_init[4] = 0.0
    return np.concatenate([kmtx_init, np.zeros(param_count - 5)])


def _finalize_outputs(out, p, refine):
    out.refine_result = refine
    out.active_views = p.active
    out.used_views = len(p.active)
    out.total_points_used = int(sum(a.corner_count for a in p.active))


def _zero_skew(cfg: IntrinsicCalibrationConfig) -> bool:
    """Skew stays frozen in the LM; a spurious Zhang skew would be locked-in
    model error, so it starts at zero when nobody asked for skew."""
    return not cfg.options.estim_options.use_skew and not cfg.options.optim_options.optimize_skew


_REFINE_FALLBACK_MSG = (
    "Warning: Non-linear refinement did not converge. Using linear result."
)


class PlanarIntrinsicCalibrationFacade:
    """facades/intrinsics.cpp:80-151, on ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def _tensor(self, a, dtype=torch.float64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _prepare(
        self,
        cfg: IntrinsicCalibrationConfig,
        cam_cfg: CameraConfig,
        detections: PlanarDetections,
    ) -> _PreparedProblem:
        out = IntrinsicCalibrationOutputs()
        out.total_input_views = len(detections.images)
        out.min_corner_threshold = cfg.options.min_corners_per_view

        obj, uv, mask, active = collect_planar_views(detections, cfg.options)
        out.accepted_views = len(active)
        if len(active) < 4:
            raise RuntimeError(
                f"Need at least 4 views with >= {cfg.options.min_corners_per_view} corners. "
                f"Only {len(active)} usable views."
            )

        # pad views and points to their buckets (padded views are masked
        # out and their pose blocks frozen in the LM)
        v_real, n_real = obj.shape[0], obj.shape[1]
        v_pad, n_pad = bucket_views(v_real), bucket_points(n_real)
        if (v_pad, n_pad) != (v_real, n_real):
            obj = np.pad(obj, ((0, v_pad - v_real), (0, n_pad - n_real), (0, 0)))
            uv = np.pad(uv, ((0, v_pad - v_real), (0, n_pad - n_real), (0, 0)))
            mask = np.pad(mask, ((0, v_pad - v_real), (0, n_pad - n_real)))
        view_valid = np.arange(v_pad) < v_real

        bounds = cfg.options.estim_options.bounds
        if bounds is None and cam_cfg.image_size is not None:
            bounds = bounds_from_image_size(cam_cfg.image_size)

        return _PreparedProblem(
            out=out, obj=obj, uv=uv, mask=mask,
            view_valid=view_valid, bounds=bounds, v_real=v_real, active=active,
        )

    @profiling.traced("prefilter")
    def _prefilter(self, problems: List[_PreparedProblem], ropts: ransac_mod.RansacOptions):
        """RANSAC homography prefilter of every real view of ``problems``
        (one point bucket) in ONE batched run, one lane per view. A view
        keeps its inliers when its RANSAC succeeded, its mask otherwise.
        Padded views are left out: they hold no data, so their RANSAC could
        only fail and keep their (empty) mask."""
        cut = np.cumsum([p.v_real for p in problems])[:-1]
        obj = np.concatenate([p.obj[: p.v_real] for p in problems])
        uv = np.concatenate([p.uv[: p.v_real] for p in problems])
        mask = self._tensor(np.concatenate([p.mask[: p.v_real] for p in problems]), torch.bool)
        rr = ransac_mod.ransac_homography(self._tensor(obj), self._tensor(uv), ropts, mask=mask)
        with profiling.sync("prefilter.keep"):
            keep = torch.where(rr.success[:, None], rr.inlier_mask, mask).cpu().numpy()
        for p, k in zip(problems, np.split(keep, cut)):
            p.mask[: p.v_real] = k

    def calibrate(
        self,
        cfg: IntrinsicCalibrationConfig,
        cam_cfg: CameraConfig,
        detections: PlanarDetections,
    ) -> IntrinsicCalibrationOutputs:
        model = get_model(cam_cfg.model)
        p = self._prepare(cfg, cam_cfg, detections)
        if cfg.options.estim_options.homography_ransac is not None:
            self._prefilter([p], cfg.options.estim_options.homography_ransac.to_options())
        out, v_real = p.out, p.v_real
        obj, uv = self._tensor(p.obj), self._tensor(p.uv)
        view_mask = self._tensor(p.mask, torch.bool)

        linear = intrinsics_linear.estimate_intrinsics(
            obj[None], uv[None], view_mask[None], bounds=p.bounds
        )
        # warning counts come back as flags, not captured cerr text
        pose_ok = planarpose.pose_from_homography_pixel(
            linear.kmtx[:, None, :], linear.homographies
        )[3]
        kmtx, k_ok, h_ok, hs, h_rms, pose_ok_h = to_numpy(
            (linear.kmtx[0], linear.ok[0], linear.h_ok[0], linear.homographies[0],
             linear.view_rms[0], pose_ok[0])
        )
        if not _fill_linear_outputs(out, p, kmtx, bool(k_ok), h_ok, hs, h_rms, pose_ok_h):
            raise RuntimeError("Linear intrinsic estimation failed to converge.")

        kmtx_init = linear.kmtx[0].clone()
        if _zero_skew(cfg):
            kmtx_init[4] = 0.0
        # [kmtx(5), zeros(rest)]: distortion starts at zero, as the
        # reference's zero-init refine (facades/intrinsics.cpp:122-128)
        init_intr = torch.cat([kmtx_init, kmtx_init.new_zeros(model.param_count - 5)])
        if cfg.options.refine:
            v = obj.shape[0]
            init_poses = planarpose.estimate_planar_pose(
                obj, uv, kmtx_init.expand(v, 5), view_mask
            )
            # padded views get a benign frozen pose (keeps residuals finite)
            safe = torch.eye(4, dtype=obj.dtype, device=self.device)
            safe[2, 3] = 1.0
            good = torch.isfinite(init_poses).all(dim=-1).all(dim=-1)
            good = good & self._tensor(p.view_valid, torch.bool)
            init_poses = torch.where(good[:, None, None], init_poses, safe)
            refine = optimize_intrinsics(
                obj, uv, init_intr, init_poses, mask=view_mask, model=model,
                opts=cfg.options.optim_options, view_valid=self._tensor(p.view_valid),
            )
            # trim bucketing padding from per-view outputs
            refine.c_se3_t = refine.c_se3_t[:v_real]
            refine.view_errors = refine.view_errors[:v_real]
            if not refine.core.success:
                print(_REFINE_FALLBACK_MSG, file=sys.stderr)
                refine.camera = init_intr.cpu().numpy()
        else:
            refine = IntrinsicsOptimizationResult(
                core=OptimResult(success=True),
                camera=init_intr.cpu().numpy(),
                c_se3_t=np.zeros((0, 4, 4)),
                view_errors=np.zeros((0,)),
            )

        _finalize_outputs(out, p, refine)
        return out

    def calibrate_many(
        self,
        cfg: IntrinsicCalibrationConfig,
        jobs: List[Tuple[CameraConfig, PlanarDetections]],
    ) -> List:
        """Fleet path: calibrate many sensors, one batched device solve per
        (view-bucket, point-bucket, bounds, model) group instead of the
        reference's per-camera loop.

        Returns one entry per job: IntrinsicCalibrationOutputs on success or
        the raised Exception for that sensor (callers report it per sensor,
        the rest of the fleet is unaffected).
        """
        if not cfg.options.refine:
            # linear-only runs are cheap; keep the simple per-sensor path
            results = []
            for cam_cfg, det in jobs:
                try:
                    results.append(self.calibrate(cfg, cam_cfg, det))
                except Exception as ex:  # noqa: BLE001 — per-sensor isolation
                    results.append(ex)
            return results

        results: List = [None] * len(jobs)
        prepared: List[Optional[_PreparedProblem]] = [None] * len(jobs)
        with profiling.span("facade.prepare"):
            for i, (cam_cfg, det) in enumerate(jobs):
                try:
                    get_model(cam_cfg.model)
                    prepared[i] = self._prepare(cfg, cam_cfg, det)
                except Exception as ex:  # noqa: BLE001 — per-sensor isolation
                    results[i] = ex
        live = [i for i, p in enumerate(prepared) if p is not None]

        ransac_cfg = cfg.options.estim_options.homography_ransac
        if ransac_cfg is not None:
            by_points: dict = {}
            for i in live:
                by_points.setdefault(prepared[i].obj.shape[1], []).append(prepared[i])
            for problems in by_points.values():
                self._prefilter(problems, ransac_cfg.to_options())

        zero_skew = _zero_skew(cfg)
        groups: dict = {}
        for i in live:
            p = prepared[i]
            groups.setdefault((p.obj.shape, p.bounds, jobs[i][0].model), []).append(i)

        opts = cfg.options.optim_options
        for (_, bounds, model_name), idxs in groups.items():
            model = get_model(model_name)
            stack = lambda field: self._tensor(np.stack([getattr(prepared[i], field) for i in idxs]))
            seed_d, pose_ok_d, refine_d, rms_chk_d = intrinsics_facade_batch(
                stack("obj"), stack("uv"), mask=stack("mask"), view_valid=stack("view_valid"),
                opts=opts, bounds=bounds, zero_skew=zero_skew, model_name=model.name,
            )
            lm_d, intr_d, poses_d, view_err_d, cov_d, cov_ok_d = refine_d
            # ONE host transfer for the whole group; the ambient covariance,
            # which the intrinsics report never writes, stays on the device
            # until read (utils/lazy.py)
            (
                kmtx_b, k_ok_b, h_ok_b, hs_b, h_rms_b, pose_ok_b, lm_out, intr_b, poses_b,
                view_err_b, cov_ok_b, rms_chk_b,
            ) = to_numpy(
                (seed_d.kmtx, seed_d.ok, seed_d.h_ok, seed_d.homographies, seed_d.view_rms,
                 pose_ok_d, lm_d, intr_d, poses_d, view_err_d, cov_ok_d, rms_chk_d)
            )
            cov_fetcher = BatchFetcher(cov_d)
            with profiling.span("facade.results"):
                for j, i in enumerate(idxs):
                    p = prepared[i]
                    out = p.out
                    if not _fill_linear_outputs(
                        out, p, kmtx_b[j], bool(k_ok_b[j]), h_ok_b[j], hs_b[j], h_rms_b[j],
                        pose_ok_b[j],
                    ):
                        results[i] = RuntimeError("Linear intrinsic estimation failed to converge.")
                        continue

                    core = OptimResult(
                        success=bool(lm_out.success[j]),
                        covariance=(
                            LazyDeviceArray(cov_fetcher, j)
                            if opts.core.compute_covariance and bool(cov_ok_b[j])
                            else None
                        ),
                        final_cost=float(lm_out.cost[j]),
                        iterations=int(lm_out.iterations[j]),
                        termination=TerminationType(int(lm_out.termination[j])),
                        initial_cost=float(lm_out.initial_cost[j]),
                    )
                    core.report = brief_report(core)
                    refine = IntrinsicsOptimizationResult(
                        core=core,
                        camera=intr_b[j],
                        c_se3_t=poses_b[j][: p.v_real],
                        view_errors=view_err_b[j][: p.v_real],
                    )
                    if model.qa_recheck:
                        out.view_rms_check = rms_chk_b[j][: p.v_real]
                        valid = np.asarray(p.view_valid[: p.v_real], bool)
                        delta = np.abs(out.view_rms_check[valid] - refine.view_errors[valid])
                        out.rms_check_warnings = int(np.sum(delta > 5e-3))
                    if not core.success:
                        print(_REFINE_FALLBACK_MSG, file=sys.stderr)
                        refine.camera = _linear_fallback_camera(kmtx_b[j], zero_skew, model.param_count)
                    _finalize_outputs(out, p, refine)
                    results[i] = out
        return results


def load_calibration_config(path) -> Optional[IntrinsicCalibrationConfig]:
    """facades/intrinsics.cpp:183-199."""
    try:
        raw = json.loads(Path(path).read_text())
        return jsonio.from_jsonable(raw, IntrinsicCalibrationConfig)
    except Exception as e:  # noqa: BLE001 — parity with catch-all
        print(f"Failed to load calibration config from {path}: {e}", file=sys.stderr)
        return None


def print_calibration_summary(out, cam_cfg: CameraConfig, outputs: IntrinsicCalibrationOutputs):
    """facades/intrinsics.cpp:153-181."""
    k = outputs.linear_kmtx
    print(f"== Camera {cam_cfg.camera_id} ==", file=out)
    if outputs.invalid_k_warnings or outputs.pose_warnings:
        print(
            f"Linear stage warnings: {outputs.invalid_k_warnings} invalid camera matrices, "
            f"{outputs.pose_warnings} homography decompositions",
            file=out,
        )
    print(f"Initial fx/fy/cx/cy: {k[0]}, {k[1]}, {k[2]}, {k[3]}", file=out)
    r = outputs.refine_result.camera
    print(f"Refined fx/fy/cx/cy: {r[0]}, {r[1]}, {r[2]}, {r[3]}", file=out)
    print(f"Distortion coeffs: {np.asarray(r[5:])}", file=out)
    print(
        f"Views considered: {outputs.total_input_views}, after threshold: {outputs.accepted_views}",
        file=out,
    )
    errs = " ".join(str(e) for e in np.asarray(outputs.refine_result.view_errors))
    print(f"Per-view RMS (px): {errs}", file=out)
