"""Hartley-normalized DLT homography estimation, masked and batched (port
of ``calibration_tpu/ops/homography.py``)."""

from __future__ import annotations

import math

import torch

from . import linalg

MIN_SAMPLES = 4
COLLINEARITY_EPS = 1e-6


def normalize_points_2d(pts, mask=None):
    """Hartley normalization transform.

    pts: (..., N, 2); mask: optional (..., N). Returns (pts_normalized, T)
    where T is the (..., 3, 3) similarity with ``pn = T @ p`` (homogeneous).
    """
    if mask is None:
        w = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
    else:
        w = mask.to(pts.dtype)
    cnt = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    centroid = torch.sum(pts * w[..., None], dim=-2) / cnt
    diff = pts - centroid[..., None, :]
    dist = torch.linalg.norm(diff, dim=-1) * w
    mean_dist = torch.sum(dist, dim=-1) / cnt[..., 0]
    pos = mean_dist > 0
    sigma = torch.where(
        pos, math.sqrt(2.0) / torch.where(pos, mean_dist, torch.ones_like(mean_dist)), 1.0
    )

    z = torch.zeros_like(sigma)
    o = torch.ones_like(sigma)
    t = torch.stack(
        [
            torch.stack([sigma, z, -sigma * centroid[..., 0]], -1),
            torch.stack([z, sigma, -sigma * centroid[..., 1]], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )
    return diff * sigma[..., None, None], t


def dlt_homography_normalized(src, dst, mask=None):
    """2N x 9 null-vector DLT on pre-normalized points. Masked rows are
    zeroed."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    row_u = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    row_v = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    a = torch.stack([row_u, row_v], dim=-2)  # (..., N, 2, 9)
    if mask is not None:
        a = a * mask[..., None, None].to(a.dtype)
    a = a.reshape(a.shape[:-3] + (2 * a.shape[-3], 9))
    h = linalg.smallest_singular_vector(a)
    hm = h.reshape(h.shape[:-1] + (3, 3))
    return hm / hm[..., 2:3, 2:3]


def estimate_homography_dlt(src, dst, mask=None):
    """Hartley-normalize both sides, DLT, denormalize. src/dst: (..., N, 2)."""
    src_n, t_src = normalize_points_2d(src, mask)
    dst_n, t_dst = normalize_points_2d(dst, mask)
    h_norm = dlt_homography_normalized(src_n, dst_n, mask)
    h = linalg.inv3(t_dst) @ h_norm @ t_src
    h22 = h[..., 2:3, 2:3]
    big = torch.abs(h22) > 1e-15
    return torch.where(big, h / torch.where(big, h22, torch.ones_like(h22)), h)


def apply_homography(h, pts):
    """h: (..., 3, 3); pts: (..., N, 2) -> (..., N, 2)."""
    ph = torch.cat([pts, torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype, device=pts.device)], -1)
    q = torch.einsum("...ij,...nj->...ni", h, ph)
    return q[..., :2] / q[..., 2:3]


def symmetric_transfer_error(h, src, dst):
    """Per-point sqrt(0.5 * (|dst - H src|^2 + |src - H^-1 dst|^2))."""
    dst_hat = apply_homography(h, src)
    src_hat = apply_homography(linalg.inv3(h), dst)
    e1 = torch.sum((dst - dst_hat) ** 2, dim=-1)
    e2 = torch.sum((src - src_hat) ** 2, dim=-1)
    return torch.sqrt(0.5 * (e1 + e2))


def has_near_collinear_triplet(pts, eps: float = COLLINEARITY_EPS):
    """Degeneracy check over every triplet of a minimal sample. pts:
    (..., K, 2), K static (4 for the homography), so the loop unrolls to
    K-choose-3 elementwise area evaluations. Returns (...,) bool."""
    k = pts.shape[-2]
    flags = []
    for i in range(k):
        for j in range(i + 1, k):
            for l in range(j + 1, k):
                a, b, c = pts[..., i, :], pts[..., j, :], pts[..., l, :]
                area = torch.abs(
                    (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
                    - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0])
                )
                flags.append(area < eps)
    return torch.stack(flags, dim=-1).any(dim=-1)


def symmetric_rms_px(h, src, dst, inlier_mask):
    """The reference's per-view aggregate sqrt(sum(residual) / (2*count))
    over inliers (it sums the residual values, not their squares)."""
    r = symmetric_transfer_error(h, src, dst)
    w = inlier_mask.to(r.dtype)
    cnt = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    return torch.sqrt(torch.sum(r * w, dim=-1) / (2.0 * cnt))


def estimate_homography(obj_xy, img_uv, mask=None, ransac_options=None):
    """DLT-on-all or RANSAC homography with diagnostics, for one problem
    (obj_xy/img_uv (N, 2)) or a batch of lanes ((L, N, 2)). Returns a dict
    mirroring HomographyResult: {"success", "hmtx", "inlier_mask",
    "symmetric_rms_px"}. The RANSAC branch is the batched
    ``ransac.ransac_homography``."""
    single = obj_xy.ndim == 2
    if single:
        obj_xy, img_uv = obj_xy[None], img_uv[None]
        mask = None if mask is None else mask[None]
    if mask is None:
        mask = torch.ones(obj_xy.shape[:-1], dtype=torch.bool, device=obj_xy.device)
    mask = mask.bool()

    if ransac_options is not None:
        from .ransac import ransac_homography

        rr = ransac_homography(obj_xy, img_uv, ransac_options, mask=mask)
        out = {"success": rr.success, "hmtx": rr.model, "inlier_mask": rr.inlier_mask}
    else:
        h = estimate_homography_dlt(obj_xy, img_uv, mask)
        ok = (mask.sum(dim=-1) >= MIN_SAMPLES) & torch.isfinite(h).all(dim=-1).all(dim=-1)
        out = {"success": ok, "hmtx": h, "inlier_mask": mask}
    out["symmetric_rms_px"] = symmetric_rms_px(out["hmtx"], obj_xy, img_uv, out["inlier_mask"])
    return {k: v[0] for k, v in out.items()} if single else out
