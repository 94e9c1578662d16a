"""Plane fits: centroid + smallest singular vector, and the 3-point
minimal fit (port of ``calibration_tpu/ops/planefit.py``). The RANSAC
wiring is ``ops.ransac.ransac_plane``.

The plane's sign follows the reference's rule. Its null vector comes from
two inverse-power steps started at the column of largest norm of the
shifted gram inverse (G + eps I)^-1, so its sign is that of the exact
eigenvector v0 with v0[c] > 0 at that column c. Column j's squared norm is
sum_k v_k[j]^2 / (lambda_k + eps)^2 over the gram's eigenpairs, so the port
finds c from ``eigh`` and flips v0 to the same sign, and an artifact's
``n``, ``d`` and homography equal the reference's sign included. Where the
two smallest eigenvalues are nearly equal the reference's two steps have
not converged (and its c can differ from the exact one): compare such fits
up to sign.
"""

from __future__ import annotations

import torch

from . import linalg


def _gram_shift(g):
    """The reference's 1e-12 relative shift of a float64 gram (its float64
    64-ulp term is smaller), plus the tiniest normal number."""
    n = g.shape[-1]
    tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(dim=-1)
    return (1e-12 / n) * tr + torch.finfo(g.dtype).tiny


def _null_vector(a):
    """Unit right singular vector of the smallest singular value of a
    (..., N, 3), with the reference's sign."""
    g = a.transpose(-1, -2) @ a
    vals, vecs = linalg.eigh(g)
    eps = _gram_shift(g)
    col_norm2 = torch.sum(vecs**2 / (vals + eps[..., None])[..., None, :] ** 2, dim=-1)  # (..., 3)
    c = torch.argmax(col_norm2, dim=-1, keepdim=True)
    v0 = vecs[..., :, 0]
    sign = torch.where(torch.gather(v0, -1, c) < 0, -1.0, 1.0).to(a.dtype)
    return v0 * sign


def fit_plane_svd(pts, mask=None):
    """Centroid + smallest right singular vector.

    pts: (..., N, 3); mask: optional (..., N). Returns (..., 4) [n, d] with
    a unit normal and n.p + d = 0.
    """
    w = torch.ones(pts.shape[:-1], dtype=pts.dtype, device=pts.device) if mask is None else mask.to(pts.dtype)
    cnt = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    centroid = torch.sum(pts * w[..., None], dim=-2) / cnt
    a = (pts - centroid[..., None, :]) * w[..., None]
    normal = _null_vector(a)
    d = -torch.sum(normal * centroid, dim=-1)
    nrm = torch.linalg.norm(normal, dim=-1, keepdim=True)
    return torch.cat([normal / nrm, (d / nrm[..., 0])[..., None]], dim=-1)


def fit_plane_3pt(p0, p1, p2):
    """Minimal 3-point plane. p0, p1, p2: (..., 3). Returns (plane (..., 4),
    ok (...,))."""
    normal = torch.linalg.cross(p1 - p0, p2 - p0)
    nrm = torch.linalg.norm(normal, dim=-1)
    ok = nrm >= 1e-12
    normal = normal / torch.clamp(nrm, min=1e-12)[..., None]
    d = -torch.sum(normal * p0, dim=-1)
    return torch.cat([normal, d[..., None]], dim=-1), ok


def plane_point_distance(plane, pts):
    """|n.p + d| per point. plane: (..., 4); pts: (..., N, 3)."""
    return torch.abs(torch.einsum("...i,...ni->...n", plane[..., :3], pts) + plane[..., 3:4])


def plane_rms(plane, pts, mask=None):
    """RMS of the signed distances over the (masked) points."""
    r = torch.einsum("...i,...ni->...n", plane[..., :3], pts) + plane[..., 3:4]
    w = torch.ones_like(r) if mask is None else mask.to(r.dtype)
    cnt = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    return torch.sqrt(torch.sum(r * r * w, dim=-1) / cnt)
