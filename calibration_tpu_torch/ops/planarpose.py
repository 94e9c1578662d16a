"""Planar pose from homography decomposition (port of
``calibration_tpu/ops/planarpose.py``).

Sign disambiguation negates (h1, h2, h3) BEFORE forming r3 = r1 x r2 so the
result stays a proper rotation, as the reference package does.
"""

from __future__ import annotations

import torch

from ..models import camera_matrix as cm
from . import homography as H
from . import linalg, se3


def pose_from_homography_normalized(hmtx):
    """Decompose a normalized-coords homography H = [r1 r2 t].
    hmtx: (..., 3, 3) -> (..., 4, 4)."""
    sign = torch.where(hmtx[..., 2, 2] < 0, -1.0, 1.0).to(hmtx.dtype)
    hm = hmtx * sign[..., None, None]
    h1, h2, h3 = hm[..., :, 0], hm[..., :, 1], hm[..., :, 2]
    s = torch.sqrt(torch.linalg.norm(h1, dim=-1) * torch.linalg.norm(h2, dim=-1))
    s = torch.where(s < 1e-12, torch.ones_like(s), s)
    r1 = h1 / s[..., None]
    r2 = h2 / s[..., None]
    r3 = torch.linalg.cross(r1, r2)
    r_init = torch.stack([r1, r2, r3], dim=-1)

    # SVD orthonormalization with det fix
    u, _, vt = linalg.svd(r_init)
    rot = u @ vt
    v_fix = vt.clone()
    v_fix[..., 2, :] = -v_fix[..., 2, :]
    rot = torch.where((linalg.det3(rot) < 0)[..., None, None], u @ v_fix, rot)
    return se3.make_se3(rot, h3 / s[..., None])


def estimate_planar_pose_normalized(obj_xy, norm_uv, mask=None):
    """DLT on already-normalized image coords, then decomposition.
    obj_xy/norm_uv: (..., N, 2)."""
    return pose_from_homography_normalized(H.estimate_homography_dlt(obj_xy, norm_uv, mask))


def estimate_planar_pose(obj_xy, img_uv, kmtx, mask=None):
    """One-shot planar pose from pixel observations and K.
    obj_xy/img_uv: (..., N, 2); kmtx: (..., 5)."""
    return estimate_planar_pose_normalized(obj_xy, cm.normalize(kmtx[..., None, :], img_uv), mask)


def pose_from_homography_pixel(kmtx, hmtx):
    """Pixel-space homography decomposition K^-1 H with mean-column-norm
    scale and t_z > 0 enforcement. Returns (pose (..., 4, 4), scale,
    cond_check, ok)."""
    hn = linalg.inv3(cm.matrix(kmtx)) @ hmtx
    n1 = torch.linalg.norm(hn[..., :, 0], dim=-1)
    n2 = torch.linalg.norm(hn[..., :, 1], dim=-1)
    eps = 1e-15
    ok = (n1 > eps) & (n2 > eps) & torch.isfinite(hmtx[..., 2, 2])
    scale = 1.0 / torch.clamp((n1 + n2) * 0.5, min=eps)
    cond = torch.where(n1 > n2, n1 / torch.clamp(n2, min=eps), n2 / torch.clamp(n1, min=eps))

    sign = torch.where(hn[..., 2, 2] <= 0, -1.0, 1.0).to(hn.dtype)
    hs = hn * sign[..., None, None]
    r1 = scale[..., None] * hs[..., :, 0]
    r2 = scale[..., None] * hs[..., :, 1]
    r3 = torch.linalg.cross(r1, r2)
    rot = se3.project_to_so3(torch.stack([r1, r2, r3], dim=-1))
    return se3.make_se3(rot, scale[..., None] * hs[..., :, 2]), scale, cond, ok


def homography_consistency_fro(kmtx, pose, hmtx):
    """Relative Frobenius mismatch between K [r1 r2 t] and H; inf where H
    is zero."""
    rt = torch.stack([pose[..., :3, 0], pose[..., :3, 1], pose[..., :3, 3]], dim=-1)
    num = torch.linalg.norm(cm.matrix(kmtx) @ rt - hmtx, dim=(-2, -1))
    den = torch.linalg.norm(hmtx, dim=(-2, -1))
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), torch.inf)
