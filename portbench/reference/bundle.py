"""Hand-eye bundle adjustment of one-camera robot cells in plain PyTorch.

One lane is one rig: O observations of a planar target, each taken at a
known gripper pose b_se3_g[o]; a target point X reaches the camera as
c_se3_t X with c_se3_t = (g_se3_c)^-1 (b_se3_g[o])^-1 b_se3_t. The camera
is fixed; the parameters are increments about base poses of g_se3_c and
b_se3_t, x = [w_g, dt_g, w_b, dt_b] (R = R0 exp([w]_x), t = t0 + dt).
Each observation is one Huber loss block, the program's cost.
"""

from __future__ import annotations

import torch

from . import lm
from .geometry import project, rodrigues, se3_inverse


def _compose(r0, t0, w, dt):
    rot = r0 @ rodrigues(w)
    return rot, t0 + dt


def residual(x, obj, uv, mask, g_b, intr, g0, b0):
    """Masked residual blocks (O, 2N) of one rig; g_b = (b_se3_g)^-1
    (O, 4, 4)."""
    rg, tg = _compose(g0[:3, :3], g0[:3, 3], x[0:3], x[3:6])
    rb, tb = _compose(b0[:3, :3], b0[:3, 3], x[6:9], x[9:12])
    rc = rg.transpose(-1, -2)  # (g_se3_c)^-1
    tc = -(rc @ tg)
    r_cb = rc @ g_b[:, :3, :3]  # (O, 3, 3): camera <- base
    t_cb = (rc @ g_b[:, :3, 3, None])[..., 0] + tc
    rot = r_cb @ rb
    tra = (r_cb @ tb[:, None])[..., 0] + t_cb
    pc = torch.einsum("oij,onj->oni", rot[..., :2], obj) + tra[:, None, :]
    r = (project(intr, pc) - uv) * mask[..., None]
    return r.reshape(obj.shape[0], -1)


def _data(obj, uv, mask, b_se3_g, intr, g0, b0, dtype):
    b = obj.shape[0]
    intr = intr.to(dtype).expand(b, intr.shape[-1])
    return tuple(t.to(dtype) for t in (obj, uv, mask, se3_inverse(b_se3_g.to(torch.float64)), intr, g0, b0))


def _poses(x, g0, b0):
    out = []
    for base, w, dt in ((g0, x[:, 0:3], x[:, 3:6]), (b0, x[:, 6:9], x[:, 9:12])):
        m = torch.zeros_like(base)
        m[..., :3, :3], m[..., :3, 3] = _compose(base[..., :3, :3], base[..., :3, 3], w, dt)
        m[..., 3, 3] = 1.0
        out.append(m)
    return out


def solve(obj, uv, mask, b_se3_g, intr, g0, b0, huber, dtype=torch.float64, iters=60):
    """Refine B rigs from g0, b0 (B, 4, 4) with the camera intr ((10,) or
    (B, 10)) fixed, in ``dtype``. Returns (g_se3_c, b_se3_t (B, 4, 4),
    cost (B,))."""
    g0, b0 = g0.to(dtype), b0.to(dtype)
    data = _data(obj, uv, mask, b_se3_g, intr, g0, b0, dtype)
    x0 = torch.zeros((obj.shape[0], 12), dtype=dtype, device=obj.device)
    x, c = lm.solve(residual, x0, data, huber, torch.ones(12, dtype=dtype, device=obj.device), iters=iters)
    g, b = _poses(x, g0, b0)
    return g, b, c


def cost(obj, uv, mask, b_se3_g, intr, g_se3_c, b_se3_t, huber):
    """The float64 robust cost (B,) of rigs at g_se3_c, b_se3_t."""
    f64 = torch.float64
    data = _data(obj, uv, mask, b_se3_g, intr, g_se3_c.to(f64), b_se3_t.to(f64), f64)
    return lm.cost(residual, torch.zeros((obj.shape[0], 12), dtype=f64, device=obj.device), data, huber)
