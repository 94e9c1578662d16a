"""Peaks of the card and the operations and bytes of the program's
kernels, frozen here (``chip_smoke.py``'s K1 bound).

NVIDIA's H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside
the tensor cores, at the 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# K1's operations per point: R [x, y, 0] + t 12, inverse depth 1, xn/yn 2,
# r^2 3, radial 6, tangential xd 10 and yd 10, K 6, residual * mask 4; RMS
# mode adds rx^2 + ry^2 and the two sums, 5
FLOPS_PER_POINT = {"residuals": 54, "rms": 59}


def bound_ms(mode, b, v, n, scalar_bytes, mask_bytes):
    """The least time the card could take for one K1 launch: bytes moved
    (each input read once, each output written once) over HBM3's
    3.35 TB/s, or operations over 67 TFLOP/s f32, whichever is larger.
    Returns (ms, "bytes" or "operations")."""
    rows, points = b * v, b * v * n
    per_point = 4 * scalar_bytes + mask_bytes + (8 if mode == "residuals" else 0)
    # poses: 12 of 16 values per row; intrinsics: per row in residual mode
    # ((R, 10) rows), per camera in RMS mode ((B, 10), shared by the views)
    nbytes = points * per_point + rows * 12 * scalar_bytes + (rows if mode == "residuals" else b) * 10 * scalar_bytes
    nbytes += rows * 4 if mode == "rms" else 0
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = points * FLOPS_PER_POINT[mode] / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
