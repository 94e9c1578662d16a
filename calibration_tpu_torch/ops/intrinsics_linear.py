"""Linear intrinsics estimation: the Zhang seed pipeline and the
normalized-observation least-squares fits (port of
``calibration_tpu/ops/intrinsics_linear.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import camera_matrix as cm
from ..models import distortion as dist
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


def _lstsq(a, b):
    """Least-squares solution of a (..., M, K) x = b (..., M), and whether
    the smallest singular value of a is at least 1e-12. A lane with a
    non-finite entry gives NaN and False."""
    finite = torch.isfinite(a).all(dim=-1).all(dim=-1) & torch.isfinite(b).all(dim=-1)
    a = torch.where(finite[..., None, None], a, 0.0)
    b = torch.where(finite[..., None], b, 0.0)
    ok = finite & (torch.linalg.svdvals(a)[..., -1] >= 1e-12)
    sol = torch.linalg.lstsq(a, b[..., None]).solution[..., 0]
    return torch.where(finite[..., None], sol, torch.nan), ok


def estimate_intrinsics_linear(xy, uv, mask=None, bounds=None, use_skew: bool = False):
    """Least-squares fit of u = fx x (+ skew y) + cx, v = fy y + cy, with the
    degeneracy check and the out-of-bounds fallback heuristics.

    xy: (..., N, 2) normalized; uv: (..., N, 2) pixels; mask: optional
    (..., N). Returns (kmtx (..., 5), ok (...,)).
    """
    if mask is None:
        mask = torch.ones(xy.shape[:-1], dtype=torch.bool, device=xy.device)
    w = mask.to(xy.dtype)
    x, y = xy[..., 0] * w, xy[..., 1] * w
    u, v = uv[..., 0] * w, uv[..., 1] * w

    au = torch.stack([x, y, w] if use_skew else [x, w], dim=-1)
    av = torch.stack([y, w], dim=-1)
    xu, ok_u = _lstsq(au, u)
    xv, ok_v = _lstsq(av, v)
    ok = ok_u & ok_v & (torch.sum(w, dim=-1) >= 2)

    fx = xu[..., 0]
    fy = xv[..., 0]
    cx = xu[..., 2] if use_skew else xu[..., 1]
    cy = xv[..., 1]
    skew = xu[..., 1] if use_skew else torch.zeros_like(fx)

    b = bounds if bounds is not None else cm.CalibrationBounds()
    out_of_bounds = (
        (fx < b.fx_min) | (fx > b.fx_max) | (fy < b.fy_min) | (fy > b.fy_max)
        | (cx < b.cx_min) | (cx > b.cx_max) | (cy < b.cy_min) | (cy > b.cy_max)
    )
    if use_skew:
        out_of_bounds = out_of_bounds | (skew < b.skew_min) | (skew > b.skew_max)

    # the fallback heuristics: a plausible focal length, the centre at half
    # the mean pixel
    cnt = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    safe = (
        torch.clamp(torch.clamp(fx, min=500.0), b.fx_min, b.fx_max),
        torch.clamp(torch.clamp(fy, min=500.0), b.fy_min, b.fy_max),
        torch.clamp(torch.sum(u, dim=-1) / cnt / 2.0, b.cx_min, b.cx_max),
        torch.clamp(torch.sum(v, dim=-1) / cnt / 2.0, b.cy_min, b.cy_max),
        torch.clamp(skew, b.skew_min, b.skew_max) if use_skew else torch.zeros_like(fx),
    )
    kmtx = torch.stack([torch.where(out_of_bounds, s, k) for s, k in zip(safe, (fx, fy, cx, cy, skew))], dim=-1)
    return kmtx, ok


def estimate_intrinsics_linear_iterative(
    xy, uv, num_radial: int = 2, max_iterations: int = 5, use_skew: bool = False, mask=None
):
    """Alternate the distortion fit and the K re-estimation for the fixed
    ``max_iterations`` (a converged iteration is a no-op update). Returns
    (kmtx (..., 5), dist_coeffs (..., num_radial + 2), ok (...,))."""
    kmtx, ok0 = estimate_intrinsics_linear(xy, uv, mask=mask, use_skew=use_skew)
    for _ in range(max_iterations):
        coeffs, _, okd = dist.fit_distortion_full(xy, uv, kmtx, num_radial, mask=mask)
        # the observations corrected by the fitted distortion
        delta = dist.apply_distortion(xy, coeffs[..., None, :]) - xy
        u_corr = uv[..., 0] - kmtx[..., 0, None] * delta[..., 0] - kmtx[..., 4, None] * delta[..., 1]
        v_corr = uv[..., 1] - kmtx[..., 1, None] * delta[..., 1]
        k_new, okk = estimate_intrinsics_linear(xy, torch.stack([u_corr, v_corr], dim=-1), mask=mask,
                                                use_skew=use_skew)
        kmtx = torch.where((okd & okk)[..., None], k_new, kmtx)
    coeffs, _, okd = dist.fit_distortion_full(xy, uv, kmtx, num_radial, mask=mask)
    return kmtx, coeffs, ok0 & okd
