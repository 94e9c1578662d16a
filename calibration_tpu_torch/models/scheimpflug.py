"""Scheimpflug (tilted-sensor) camera wrapping the pinhole base camera
(port of ``calibration_tpu/models/scheimpflug.py``).

Flat packing appends the two tilt angles to the base camera's parameters:
``[...pinhole(10), tau_x, tau_y]``, 12 parameters. ``project`` and
``unproject`` share one sensor-rotation function and the documented
linear-shift math, as the reference does (its ``unproject`` deliberately
fixes the C++ original's inconsistent shift). The trigonometry is
``torch.sin`` / ``torch.cos``: the reference's accurate-trig module answered
a TPU fault that CUDA does not have.
"""

from __future__ import annotations

import torch

from . import pinhole

PARAM_COUNT = pinhole.PARAM_COUNT + 2
IDX_TAU_X = pinhole.PARAM_COUNT
IDX_TAU_Y = pinhole.PARAM_COUNT + 1
IDX_FX, IDX_FY, IDX_SKEW = pinhole.IDX_FX, pinhole.IDX_FY, pinhole.IDX_SKEW


def base_of(intr):
    return intr[..., : pinhole.PARAM_COUNT]


def pack(base_intr, tau_x, tau_y):
    base_intr = torch.as_tensor(base_intr)
    tau = torch.stack([torch.as_tensor(t, dtype=base_intr.dtype) for t in (tau_x, tau_y)], dim=-1)
    return torch.cat([base_intr, tau], dim=-1)


def _sensor_rotation(intr):
    """R = Ry(tau_y) Rx(tau_x); its columns are the tilted sensor's basis
    (axis, base, normal)."""
    tx = intr[..., IDX_TAU_X]
    ty = intr[..., IDX_TAU_Y]
    sx, cx = torch.sin(tx), torch.cos(tx)
    sy, cy = torch.sin(ty), torch.cos(ty)
    return torch.stack(
        [
            torch.stack([cy, sx * sy, cx * sy], -1),
            torch.stack([torch.zeros_like(cx), cx, -sx], -1),
            torch.stack([-sy, sx * cy, cx * cy], -1),
        ],
        dim=-2,
    )


def _principal_intersection(rot):
    """(mx0, my0): where the principal ray meets the tilted plane."""
    return rot[..., 2, 0] / rot[..., 2, 2], rot[..., 2, 1] / rot[..., 2, 2]


def project(intr, xyz):
    """3D camera-frame point -> pixel. intr: (..., 12); xyz: (..., 3)."""
    rot = _sensor_rotation(intr)
    axis, base, normal = rot[..., :, 0], rot[..., :, 1], rot[..., :, 2]
    sden = torch.sum(normal * xyz, dim=-1)
    mx = torch.sum(axis * xyz, dim=-1) / sden
    my = torch.sum(base * xyz, dim=-1) / sden
    mx0, my0 = _principal_intersection(rot)
    px_delta = pinhole.project_normalized(base_of(intr), torch.stack([mx - mx0, my - my0], dim=-1))
    return px_delta + pinhole.apply_linear_intrinsics(base_of(intr), torch.stack([mx0, my0], -1))


def unproject(intr, pixel):
    """Pixel -> tilted-sensor plane coordinates (mx, my)."""
    rot = _sensor_rotation(intr)
    mx0, my0 = _principal_intersection(rot)
    base_shift = pinhole.apply_linear_intrinsics(base_of(intr), torch.stack([mx0, my0], -1))
    dxy = pinhole.unproject(base_of(intr), pixel - base_shift)
    return torch.stack([dxy[..., 0] + mx0, dxy[..., 1] + my0], dim=-1)


def plane_point_to_ray(intr, mxy):
    """Tilted-plane coordinates -> 3D ray direction in the camera frame:
    mx * axis + my * base + normal."""
    rot = _sensor_rotation(intr)
    return mxy[..., 0:1] * rot[..., :, 0] + mxy[..., 1:2] * rot[..., :, 1] + rot[..., :, 2]


def unproject_normalized(intr, pixel):
    """Pixel -> z = 1 normalized camera-frame coordinates (ray / ray_z), the
    model-generic form that line-scan geometry needs."""
    ray = plane_point_to_ray(intr, unproject(intr, pixel))
    return ray[..., :2] / ray[..., 2:3]


def apply_intrinsics(intr, pixel):
    return pinhole.apply_intrinsics(base_of(intr), pixel)


def remove_intrinsics(intr, xy):
    return pinhole.remove_intrinsics(base_of(intr), xy)
