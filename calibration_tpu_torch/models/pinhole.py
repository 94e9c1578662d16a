"""Pinhole camera with Brown-Conrady distortion (port of
``calibration_tpu/models/pinhole.py``).

Flat packing ``[fx, fy, cx, cy, skew, k1, k2, k3, p1, p2]``, as in the
reference's ``CameraTraits``.
"""

from __future__ import annotations

import torch

from . import camera_matrix as cm
from . import distortion as dist

PARAM_COUNT = 10
NUM_DIST_COEFFS = 5
IDX_FX, IDX_FY, IDX_SKEW = 0, 1, 4


def kmtx_of(intr):
    return intr[..., :5]


def dist_of(intr):
    return intr[..., 5:]


def pack(kmtx, coeffs):
    """The flat 10-vector from K (..., 5) and coefficients [k.., p1, p2]
    (..., D), D <= 5: zeros go between the radial and tangential terms."""
    kmtx, coeffs = torch.as_tensor(kmtx), torch.as_tensor(coeffs)
    d = coeffs.shape[-1]
    if d < NUM_DIST_COEFFS:
        nrad = d - 2
        zeros = coeffs.new_zeros(coeffs.shape[:-1] + (3 - nrad,))
        coeffs = torch.cat([coeffs[..., :nrad], zeros, coeffs[..., nrad:]], dim=-1)
    return torch.cat([kmtx, coeffs.to(kmtx.dtype)], dim=-1)


def distort(intr, xy):
    """Normalized point -> distorted normalized point."""
    return dist.apply_distortion(xy, dist_of(intr))


def undistort_pt(intr, xy):
    """Distorted normalized point -> normalized point."""
    return dist.undistort(xy, dist_of(intr))


def apply_intrinsics(intr, pixel):
    """Pixel -> normalized coordinates."""
    return cm.normalize(intr[..., :5], pixel)


def remove_intrinsics(intr, xy):
    """Normalized coordinates -> pixel."""
    return cm.denormalize(intr[..., :5], xy)


def project(intr, xyz):
    """3D camera-frame point -> pixel. intr: (..., 10); xyz: (..., 3)."""
    norm = xyz[..., :2] / xyz[..., 2:3]
    return cm.denormalize(intr[..., :5], dist.apply_distortion(norm, intr[..., 5:]))


def project_normalized(intr, xy):
    """Normalized point -> pixel (distortion, then K)."""
    return cm.denormalize(intr[..., :5], dist.apply_distortion(xy, intr[..., 5:]))


def unproject(intr, pixel):
    """Pixel -> undistorted normalized coordinates."""
    return dist.undistort(cm.normalize(intr[..., :5], pixel), intr[..., 5:])


def apply_linear_intrinsics(intr, xy):
    """fx, fy and skew only, no principal point (the Scheimpflug model's
    principal-ray shift)."""
    u = intr[..., 0] * xy[..., 0] + intr[..., 4] * xy[..., 1]
    v = intr[..., 1] * xy[..., 1]
    return torch.stack([u, v], dim=-1)


def remove_linear_intrinsics(intr, uv):
    """Inverse of ``apply_linear_intrinsics``."""
    y = uv[..., 1] / intr[..., 1]
    x = (uv[..., 0] - intr[..., 4] * y) / intr[..., 0]
    return torch.stack([x, y], dim=-1)


def project_point_jacobians(intr, xyz):
    """Analytic per-point Jacobians of ``project``: the chain rule of
    denormalize(distort(hnormalized(xyz))).

    intr: (..., 10); xyz: (..., N, 3), the leading dims of both broadcast.
    Returns (j_intr (..., N, 2, 10), h (..., N, 2, 3)) with j_intr =
    d(u, v)/d intr in packing order and h = d(u, v)/d xyz.
    """
    iz = 1.0 / xyz[..., 2]
    x = xyz[..., 0] * iz
    y = xyz[..., 1] * iz

    p = intr[..., None, :]  # broadcast the camera over the N points
    fx, fy, sk = p[..., 0], p[..., 1], p[..., 4]
    k1, k2, k3, p1, p2 = p[..., 5], p[..., 6], p[..., 7], p[..., 8], p[..., 9]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    drad = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r4
    xy = x * y
    xd = x * rad + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy

    fx, fy, sk, xd, yd = torch.broadcast_tensors(fx, fy, sk, xd, yd)
    z = torch.zeros_like(xd)
    o = torch.ones_like(xd)

    # d(xd, yd)/d(coeff) for [k1, k2, k3, p1, p2]
    dxd_k = (x * r2, x * r4, x * r6, 2.0 * xy, r2 + 2.0 * x * x)
    dyd_k = (y * r2, y * r4, y * r6, r2 + 2.0 * y * y, 2.0 * xy)

    cols = [
        torch.stack([xd, z], -1),  # fx
        torch.stack([z, yd], -1),  # fy
        torch.stack([o, z], -1),  # cx
        torch.stack([z, o], -1),  # cy
        torch.stack([yd, z], -1),  # skew
    ]
    for dx_c, dy_c in zip(dxd_k, dyd_k):
        cols.append(torch.stack(torch.broadcast_tensors(fx * dx_c + sk * dy_c, fy * dy_c), -1))
    j_intr = torch.stack(cols, dim=-1)  # (..., N, 2, 10)

    # G = d(u, v)/d(x, y) = [[fx, sk], [0, fy]] @ d(xd, yd)/d(x, y)
    dxdx = rad + 2.0 * x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x
    dxdy = 2.0 * xy * drad + 2.0 * p1 * x + 2.0 * p2 * y
    dydy = rad + 2.0 * y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x
    g00 = fx * dxdx + sk * dxdy
    g01 = fx * dxdy + sk * dydy
    g10 = fy * dxdy
    g11 = fy * dydy

    # H = G @ d(x, y)/d xyz, with d(x, y)/d xyz = [[iz, 0, -x iz], [0, iz, -y iz]]
    h = torch.stack(
        [
            torch.stack([g00 * iz, g01 * iz, -(g00 * x + g01 * y) * iz], -1),
            torch.stack([g10 * iz, g11 * iz, -(g10 * x + g11 * y) * iz], -1),
        ],
        dim=-2,
    )  # (..., N, 2, 3)
    return j_intr, h
