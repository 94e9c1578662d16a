"""Brown-Conrady lens distortion, the forward map and its fixed-point
inverse (port of ``calibration_tpu/models/distortion.py``:
``apply_distortion`` and ``undistort``).

Coefficients are ``[k1..kn, p1, p2]``: n radial terms, then two tangential.
"""

from __future__ import annotations

import torch

UNDISTORT_ITERS = 5  # the reference's fixed schedule


def apply_distortion(xy, coeffs):
    """Forward Brown-Conrady distortion of normalized coords.

    xy: (..., 2); coeffs: (..., D) with D >= 2 and D-2 radial terms.
    """
    num_radial = coeffs.shape[-1] - 2
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = torch.ones_like(r2)
    rpow = r2
    for i in range(num_radial):
        radial = radial + coeffs[..., i] * rpow
        rpow = rpow * r2
    p1 = coeffs[..., num_radial]
    p2 = coeffs[..., num_radial + 1]
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort(xy, coeffs, iters: int = UNDISTORT_ITERS):
    """Inverse distortion by ``iters`` fixed-point iterations (the
    reference's fixed schedule)."""
    und = xy
    for _ in range(iters):
        und = und + (xy - apply_distortion(und, coeffs))
    return und
