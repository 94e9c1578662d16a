"""Line-scan laser-plane calibration: lift laser pixels through each
view's target homography into 3D, then fit a plane (port of
``calibration_tpu/ops/linescan.py``).

The reference vmaps one view's lift over views and one rig's calibration
over rigs; here every function takes leading batch axes, so one call
serves rigs and views together. The lift and the SVD fit are separate
functions, so the RANSAC path runs only the lift: eager PyTorch would run
an SVD fit whose result nobody reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import homography as H
from . import linalg, planarpose, planefit


def build_plane_homography(plane):
    """Plane-basis inverse map. plane: (..., 4) -> (..., 3, 3)."""
    nvec = plane[..., :3]
    p0 = -plane[..., 3:4] * nvec
    use_z = (torch.abs(nvec[..., 2]) < 0.9)[..., None]
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=plane.dtype, device=plane.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=plane.dtype, device=plane.device)
    e1 = torch.linalg.cross(nvec, torch.where(use_z, ez, ex))
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(nvec, e1)
    e2 = e2 / torch.linalg.norm(e2, dim=-1, keepdim=True)
    return linalg.inv3(torch.stack([e1, e2, p0], dim=-1))


def points_from_view(obj_xy, target_norm_uv, laser_norm_uv, target_mask=None):
    """Lift laser pixels (already unprojected to normalized coordinates by
    the camera model) to 3D camera-frame points on the target plane.

    obj_xy/target_norm_uv: (..., N, 2); laser_norm_uv: (..., L, 2); target
    mask optional (..., N). Returns (points (..., L, 3), ok (...,)).
    """
    hm = H.estimate_homography_dlt(obj_xy, target_norm_uv, target_mask)
    ok = torch.isfinite(hm).all(dim=-1).all(dim=-1)
    pose = planarpose.pose_from_homography_normalized(hm)
    h_norm_to_obj = linalg.inv3(hm)
    h22 = h_norm_to_obj[..., 2:3, 2:3]
    big = torch.abs(h22) > 1e-15
    h_norm_to_obj = torch.where(big, h_norm_to_obj / torch.where(big, h22, torch.ones_like(h22)), h_norm_to_obj)
    plane_xy = H.apply_homography(h_norm_to_obj, laser_norm_uv)  # (..., L, 2)
    obj_pts = torch.cat([plane_xy, torch.zeros_like(plane_xy[..., :1])], dim=-1)
    cam_pts = obj_pts @ pose[..., :3, :3].transpose(-1, -2) + pose[..., None, :3, 3]
    return cam_pts, ok


class LineScanResult(NamedTuple):
    plane: torch.Tensor  # (..., 4)
    covariance: torch.Tensor  # (..., 4, 4) zero, as the reference's
    homography: torch.Tensor  # (..., 3, 3)
    rms_error: torch.Tensor
    inlier_count: torch.Tensor
    ok: torch.Tensor


def lift_laser_points(obj_xy, target_norm_uv, laser_norm_uv, target_mask=None, laser_mask=None):
    """Every view's laser pixels lifted to 3D, pooled per rig: the points
    both plane fits (SVD, RANSAC) take.

    Arguments as ``calibrate_laser_plane``. Returns (points (..., V*L, 3),
    point mask (..., V*L), views_ok (...,)): a view whose homography is not
    finite contributes no point, and ``views_ok`` is whether every view's
    is finite.
    """
    pts, ok_views = points_from_view(obj_xy, target_norm_uv, laser_norm_uv, target_mask)
    lead = pts.shape[:-3]
    if laser_mask is None:
        laser_mask = torch.ones(laser_norm_uv.shape[:-1], dtype=torch.bool, device=laser_norm_uv.device)
    lm_flat = (laser_mask.bool() & ok_views[..., None]).reshape(lead + (-1,))
    return pts.reshape(lead + (-1, 3)), lm_flat, ok_views.all(dim=-1)


def fit_laser_plane(pts, pts_mask, views_ok):
    """The SVD plane fit of lifted laser points (``lift_laser_points``'
    outputs): a LineScanResult whose rig is ``ok`` when every view's
    homography is finite and at least 3 points remain."""
    plane = planefit.fit_plane_svd(pts, pts_mask)
    rms = planefit.plane_rms(plane, pts, pts_mask)
    count = pts_mask.sum(dim=-1)
    return LineScanResult(
        plane, plane.new_zeros(pts.shape[:-2] + (4, 4)), build_plane_homography(plane), rms, count,
        views_ok & (count >= 3),
    )


def calibrate_laser_plane(obj_xy, target_norm_uv, laser_norm_uv, target_mask=None, laser_mask=None):
    """SVD-fit laser-plane calibration of rigs: ``lift_laser_points`` then
    ``fit_laser_plane``.

    obj_xy/target_norm_uv: (..., V, N, 2); laser_norm_uv: (..., V, L, 2);
    masks optional (..., V, N) and (..., V, L). Pixels must already be
    unprojected through the camera. Returns (LineScanResult, points
    (..., V*L, 3), point mask (..., V*L)).
    """
    pts, pts_mask, views_ok = lift_laser_points(obj_xy, target_norm_uv, laser_norm_uv, target_mask, laser_mask)
    return fit_laser_plane(pts, pts_mask, views_ok), pts, pts_mask
