"""Rotations and the pinhole Brown-Conrady camera in plain PyTorch."""

from __future__ import annotations

import torch


def hat(w):
    """[w]_x for w (..., 3): (..., 3, 3)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def rodrigues(w):
    """exp([w]_x) for rotation vectors w (..., 3), smooth at w = 0 (series
    below 1e-8 rad^2), so forward-mode derivatives stay finite there."""
    lead = w.shape[:-1]
    w = w.reshape(-1, 3)  # never 0-dim: forward mode promotes a 0-dim tensor's tangent by a Python float to float64
    th2 = (w * w).sum(-1)
    small = (th2 < 1e-8).to(w.dtype)  # a blend, not torch.where, keeps forward-mode tangents in w's dtype
    th = torch.sqrt(torch.clamp(th2, min=1e-8))
    a = small * (1.0 - th2 / 6.0) + (1.0 - small) * (torch.sin(th) / th)
    b = small * (0.5 - th2 / 24.0) + (1.0 - small) * ((1.0 - torch.cos(th)) / (th * th))
    k = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return (eye + a[..., None, None] * k + b[..., None, None] * (k @ k)).reshape(lead + (3, 3))


def rotation_angle_deg(ra, rb):
    """Angle in degrees between rotations ra and rb (..., 3, 3), from
    |ra - rb|_F = 2 sqrt(2) sin(angle / 2), exact for small angles too."""
    d = torch.linalg.matrix_norm(ra - rb) / (2.0 * 2.0 ** 0.5)
    return torch.rad2deg(2.0 * torch.arcsin(d.clamp(max=1.0)))


def se3_inverse(m):
    r = m[..., :3, :3].transpose(-1, -2)
    t = -(r @ m[..., :3, 3:4])[..., 0]
    out = torch.zeros_like(m)
    out[..., :3, :3] = r
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def project(intr, pc):
    """Camera-frame points pc (..., 3) -> pixels (..., 2) through the
    camera intr (..., 10) = [fx, fy, cx, cy, skew, k1, k2, k3, p1, p2],
    which broadcasts against pc's leading dims."""
    x = pc[..., 0] / pc[..., 2]
    y = pc[..., 1] / pc[..., 2]
    fx, fy, cx, cy, skew, k1, k2, k3, p1, p2 = intr.unbind(-1)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([fx * xd + skew * yd + cx, fy * yd + cy], -1)
