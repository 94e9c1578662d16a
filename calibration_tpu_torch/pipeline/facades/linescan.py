"""Line-scan laser-plane facade (port of
``calibration_tpu/pipeline/facades/linescan.py``).

The facade unprojects target and laser pixels through the full camera
model (distortion, and sensor tilt for Scheimpflug), lifts the laser points
to 3D, and fits the plane by SVD or RANSAC, on one explicit torch device.

The reference turns any exception into ``success = False``. Here only the
facade's own validation failures do (too few views, too few target points
in a view, a camera vector of the wrong length for the model, too few laser
points, a failed RANSAC fit); any other exception, a failed launch on the
card for one, propagates.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ...models.registry import PINHOLE, CameraModelSpec, get_model
from ...ops import linescan as ls
from ...ops import planefit, ransac as ransac_mod
from .intrinsics import RansacConfig


@dataclasses.dataclass
class LineScanViewData:
    """One view: target correspondences and laser pixels."""

    obj_xy: np.ndarray  # (N, 2) target plane coords
    img_uv: np.ndarray  # (N, 2) target pixel detections
    laser_uv: np.ndarray  # (L, 2) laser line pixels


@dataclasses.dataclass
class LineScanPlaneFitOptions:
    use_ransac: bool = False
    ransac_options: RansacConfig = dataclasses.field(default_factory=RansacConfig)


@dataclasses.dataclass
class LinescanCalibrationOptions:
    plane_fit: LineScanPlaneFitOptions = dataclasses.field(default_factory=LineScanPlaneFitOptions)


@dataclasses.dataclass
class LineScanCalibrationResult:
    plane: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4))
    covariance: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((4, 4)))
    homography: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    rms_error: float = 0.0
    summary: str = ""
    inlier_count: int = 0


@dataclasses.dataclass
class LinescanCalibrationRunResult:
    success: bool = False
    used_views: int = 0
    result: LineScanCalibrationResult = dataclasses.field(default_factory=LineScanCalibrationResult)


class LinescanValidationError(ValueError):
    """A failure the facade reports as ``success = False``."""


def validate_observations(views: List[LineScanViewData]) -> None:
    if len(views) < 2:
        raise LinescanValidationError("At least 2 views are required")
    if any(v.obj_xy.shape[0] < 4 for v in views):
        raise LinescanValidationError("Each view requires >=4 target correspondences")


def _padded(views: List[LineScanViewData]):
    """(obj, target uv, target mask, laser uv, laser mask), views padded to
    the largest target and laser counts."""
    nt = max(v.obj_xy.shape[0] for v in views)
    nl = max(v.laser_uv.shape[0] for v in views)
    obj, tgt_uv = np.zeros((len(views), nt, 2)), np.zeros((len(views), nt, 2))
    laser = np.zeros((len(views), nl, 2))
    tmask, lmask = np.zeros((len(views), nt), bool), np.zeros((len(views), nl), bool)
    for i, v in enumerate(views):
        k, kl = v.obj_xy.shape[0], v.laser_uv.shape[0]
        obj[i, :k], tgt_uv[i, :k], tmask[i, :k] = v.obj_xy, v.img_uv, True
        laser[i, :kl], lmask[i, :kl] = v.laser_uv, True
    return obj, tgt_uv, tmask, laser, lmask


class LinescanCalibrationFacade:
    """Camera -> laser plane, on ``device``. Generic over the camera model:
    pass ``model`` (a spec or a registry name, default pinhole) and a
    matching flat intrinsics vector (12 parameters for Scheimpflug)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def calibrate(
        self,
        camera: np.ndarray,  # flat intrinsics (model.param_count,)
        views: List[LineScanViewData],
        opts: Optional[LinescanCalibrationOptions] = None,
        model: CameraModelSpec | str = PINHOLE,
    ) -> LinescanCalibrationRunResult:
        opts = opts or LinescanCalibrationOptions()
        model = get_model(model if isinstance(model, str) else model.name)
        out = LinescanCalibrationRunResult(used_views=len(views))
        try:
            out.result = self._fit(camera, views, opts, model)
            out.success = True
        except LinescanValidationError:
            out.success = False
        return out

    def _fit(self, camera, views, opts, model) -> LineScanCalibrationResult:
        validate_observations(views)
        camera = np.asarray(camera, np.float64)
        if camera.shape[-1] != model.param_count:
            raise LinescanValidationError(
                f"camera has {camera.shape[-1]} params; model '{model.name}' expects {model.param_count}"
            )
        obj, tgt_uv, tmask, laser, lmask = (torch.as_tensor(a, device=self.device) for a in _padded(views))
        cam = torch.as_tensor(camera, device=self.device)[None, None]
        pts, pts_mask, views_ok = ls.lift_laser_points(
            obj, model.unproject_normalized(cam, tgt_uv), model.unproject_normalized(cam, laser),
            target_mask=tmask, laser_mask=lmask,
        )
        if int(pts_mask.sum()) < 3:
            raise LinescanValidationError("Not enough laser points to fit a plane")

        r = LineScanCalibrationResult()
        if opts.plane_fit.use_ransac:
            rr = ransac_mod.ransac_plane(pts[None], opts.plane_fit.ransac_options.to_options(), mask=pts_mask[None])
            if not bool(rr.success[0]):
                raise LinescanValidationError("RANSAC plane fitting failed")
            plane, hm = rr.model[0], ls.build_plane_homography(rr.model[0])
            r.summary = "ransac"
            r.inlier_count = int(rr.inlier_count[0])
            r.rms_error = float(planefit.plane_rms(plane, pts, rr.inlier_mask[0]))
        else:
            res = ls.fit_laser_plane(pts, pts_mask, views_ok)
            plane, hm = res.plane, res.homography
            r.summary = "linear_svd"
            r.inlier_count = int(res.inlier_count)
            r.rms_error = float(res.rms_error)
        r.plane = plane.cpu().numpy()
        r.homography = hm.cpu().numpy()
        return r
