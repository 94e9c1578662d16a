"""Linear intrinsics estimation: the Zhang seed pipeline (port of
``calibration_tpu/ops/intrinsics_linear.py::estimate_intrinsics``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import camera_matrix as cm
from . import homography as H
from . import planarpose, zhang


class IntrinsicsEstimate(NamedTuple):
    kmtx: torch.Tensor  # (..., 5)
    ok: torch.Tensor  # (...,) bool
    homographies: torch.Tensor  # (..., V, 3, 3)
    h_ok: torch.Tensor  # (..., V)
    c_se3_t: torch.Tensor  # (..., V, 4, 4) per-view poses
    view_rms: torch.Tensor  # (..., V) symmetric homography RMS


def estimate_intrinsics(obj_xy, img_uv, mask=None, bounds=None):
    """Per-view DLT homographies -> Zhang K -> sanitize -> per-view pose
    decomposition. obj_xy/img_uv: (..., V, N, 2); mask: optional (..., V, N).
    The leading dims are a batch of cameras (the reference vmaps a
    single-camera function over them)."""
    if mask is None:
        mask = torch.ones(img_uv.shape[:-1], dtype=torch.bool, device=img_uv.device)
    h_ok = torch.sum(mask.to(torch.int64), dim=-1) >= H.MIN_SAMPLES

    hs = H.estimate_homography_dlt(obj_xy, img_uv, mask)
    h_ok = h_ok & torch.isfinite(hs).all(dim=-1).all(dim=-1)
    view_rms = H.symmetric_rms_px(hs, obj_xy, img_uv, mask)

    kvec, k_ok = zhang.zhang_intrinsics_from_hs(hs, h_ok)
    kvec, _ = cm.sanitize_intrinsics(kvec, bounds)

    poses, _, _, _ = planarpose.pose_from_homography_pixel(kvec[..., None, :], hs)
    return IntrinsicsEstimate(kvec, k_ok, hs, h_ok, poses, view_rms)
