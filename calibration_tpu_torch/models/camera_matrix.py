"""5-parameter intrinsic camera matrix ops (port of
``calibration_tpu/models/camera_matrix.py``).

An intrinsic matrix is a flat ``(..., 5)`` tensor ``[fx, fy, cx, cy, skew]``.
"""

from __future__ import annotations

import dataclasses

import torch


def matrix(k):
    """(..., 5) -> (..., 3, 3) upper-triangular K."""
    fx, fy, cx, cy, skew = k.unbind(-1)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack(
        [
            torch.stack([fx, skew, cx], -1),
            torch.stack([z, fy, cy], -1),
            torch.stack([z, z, o], -1),
        ],
        dim=-2,
    )


def from_matrix(m):
    """(..., 3, 3) -> (..., 5) [fx, fy, cx, cy, skew]."""
    return torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 0, 2], m[..., 1, 2], m[..., 0, 1]], dim=-1)


def normalize(k, pixel):
    """Pixel -> normalized coordinates. k: (..., 5); pixel: (..., 2)."""
    y = (pixel[..., 1] - k[..., 3]) / k[..., 1]
    x = (pixel[..., 0] - k[..., 2] - k[..., 4] * y) / k[..., 0]
    return torch.stack([x, y], dim=-1)


def denormalize(k, xy):
    """Normalized -> pixel coordinates."""
    u = k[..., 0] * xy[..., 0] + k[..., 4] * xy[..., 1] + k[..., 2]
    v = k[..., 1] * xy[..., 1] + k[..., 3]
    return torch.stack([u, v], dim=-1)


@dataclasses.dataclass(frozen=True)
class CalibrationBounds:
    """Default parameter box (same fields and defaults as the JAX package)."""

    fx_min: float = 0.0
    fx_max: float = 2000.0
    fy_min: float = 0.0
    fy_max: float = 2000.0
    cx_min: float = 0.0
    cx_max: float = 1280.0
    cy_min: float = 0.0
    cy_max: float = 720.0
    skew_min: float = -0.01
    skew_max: float = 0.01


def sanitize_intrinsics(k, bounds: CalibrationBounds | None):
    """Clamp/repair K against bounds. Returns (sanitized_k, modified_flag).

    Non-finite or out-of-box principal points snap to the box midpoint;
    focals below the minimum snap to it; bad skew snaps to 0 clipped into
    the skew box.
    """
    if bounds is None:
        return k, torch.zeros(k.shape[:-1], dtype=torch.bool, device=k.device)

    fx, fy, cx, cy, skew = k.unbind(-1)

    def fix_focal(v, lo):
        bad = ~torch.isfinite(v) | (v < lo)
        return torch.where(bad, torch.full_like(v, lo), v), bad

    def fix_pp(v, lo, hi):
        bad = ~torch.isfinite(v) | (v < lo) | (v > hi)
        return torch.where(bad, torch.full_like(v, 0.5 * (lo + hi)), v), bad

    fx2, b1 = fix_focal(fx, bounds.fx_min)
    fy2, b2 = fix_focal(fy, bounds.fy_min)
    cx2, b3 = fix_pp(cx, bounds.cx_min, bounds.cx_max)
    cy2, b4 = fix_pp(cy, bounds.cy_min, bounds.cy_max)
    s_lo = min(bounds.skew_min, bounds.skew_max)
    s_hi = max(bounds.skew_min, bounds.skew_max)
    bad_s = ~torch.isfinite(skew) | (skew < s_lo) | (skew > s_hi)
    skew2 = torch.where(bad_s, torch.full_like(skew, min(max(0.0, s_lo), s_hi)), skew)
    out = torch.stack([fx2, fy2, cx2, cy2, skew2], dim=-1)
    return out, b1 | b2 | b3 | b4 | bad_s
