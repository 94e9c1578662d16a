"""Planar intrinsics (Zhang's problem) in plain PyTorch.

One lane is one camera: V views of a planar target, each with its pose.
Parameters x = [camera (10), rotation increments (3V), translation
increments (3V)] about base poses (R0, t0): R_v = R0_v exp([w_v]_x),
t_v = t0_v + dt_v. The camera is [fx, fy, cx, cy, skew, k1, k2, k3, p1,
p2]; skew stays frozen, as the program freezes it. Each view is one Huber
loss block of its masked pixel residuals, the program's cost.
"""

from __future__ import annotations

import torch

from . import lm
from .geometry import project, rodrigues

PARAMS = 10
SKEW = 4
FREE_INTRINSICS = [i for i in range(PARAMS) if i != SKEW]


def residual(x, obj, uv, mask, r0, t0):
    """Masked residual blocks (V, 2N) of one camera."""
    v = obj.shape[0]
    intr = x[:PARAMS]
    w = x[PARAMS:PARAMS + 3 * v].reshape(v, 3)
    dt = x[PARAMS + 3 * v:].reshape(v, 3)
    rot = r0 @ rodrigues(w)
    tra = t0 + dt
    pc = torch.einsum("vij,vnj->vni", rot[..., :2], obj) + tra[:, None, :]
    r = (project(intr, pc) - uv) * mask[..., None]
    return r.reshape(v, -1)


def _free(v, dtype, device, intrinsics=True, poses=True):
    free = torch.zeros(PARAMS + 6 * v, dtype=dtype, device=device)
    if intrinsics:
        free[FREE_INTRINSICS] = 1.0
    if poses:
        free[PARAMS:] = 1.0
    return free


def _data(obj, uv, mask, poses, dtype):
    return tuple(t.to(dtype) for t in (obj, uv, mask, poses[..., :3, :3], poses[..., :3, 3]))


def _x(intr, v, dtype):
    return torch.cat([intr.to(dtype), torch.zeros((intr.shape[0], 6 * v), dtype=dtype, device=intr.device)], -1)


def _poses(x, poses0, v):
    b = x.shape[0]
    rot = poses0[..., :3, :3] @ rodrigues(x[:, PARAMS:PARAMS + 3 * v].reshape(b, v, 3))
    out = torch.zeros_like(poses0)
    out[..., :3, :3] = rot
    out[..., :3, 3] = poses0[..., :3, 3] + x[:, PARAMS + 3 * v:].reshape(b, v, 3)
    out[..., 3, 3] = 1.0
    return out


def solve(obj, uv, mask, intr0, poses0, huber, dtype=torch.float64, intrinsics=True, iters=60):
    """Refine B cameras from intr0 (B, 10) and poses0 (B, V, 4, 4) in
    ``dtype``; with ``intrinsics`` false only the poses move. Returns
    (intr (B, 10), poses (B, V, 4, 4), cost (B,)), all in ``dtype``."""
    v = obj.shape[1]
    poses0 = poses0.to(dtype)
    data = _data(obj, uv, mask, poses0, dtype)
    free = _free(v, dtype, obj.device, intrinsics=intrinsics)
    x, c = lm.solve(residual, _x(intr0, v, dtype), data, huber, free, iters=iters)
    return x[:, :PARAMS], _poses(x, poses0, v), c


def cost(obj, uv, mask, intr, poses, huber):
    """The float64 robust cost (B,) of cameras intr (B, 10) with poses
    (B, V, 4, 4)."""
    f64 = torch.float64
    return lm.cost(residual, _x(intr, obj.shape[1], f64), _data(obj, uv, mask, poses.to(f64), f64), huber)


def intrinsic_variances(obj, uv, mask, intr, poses, huber, dtype=torch.float64):
    """Variances (B, 9) of the free camera parameters (FREE_INTRINSICS
    order) from the inverse IRLS Gauss-Newton matrix at the solution, in
    ``dtype``: the program's covariance block."""
    v = obj.shape[1]
    return lm.marginal_variances(
        residual, _x(intr, v, dtype), _data(obj, uv, mask, poses.to(dtype), dtype), huber,
        _free(v, dtype, obj.device), FREE_INTRINSICS,
    )


def view_rms(obj, uv, mask, intr, poses, dtype=torch.float64):
    """Per-view reprojection RMS (B, V): sqrt(sum r^2 / (2 max(count, 1)))
    over the masked points, computed in ``dtype``."""
    rot, tra = poses[..., :3, :3].to(dtype), poses[..., :3, 3].to(dtype)
    pc = torch.einsum("bvij,bvnj->bvni", rot[..., :2], obj.to(dtype)) + tra[:, :, None, :]
    m = mask.to(dtype)
    r = (project(intr.to(dtype)[:, None, None, :], pc) - uv.to(dtype)) * m[..., None]
    cnt = torch.clamp(m.sum(-1), min=1.0)
    return torch.sqrt((r * r).sum((-2, -1)) / (2.0 * cnt))
