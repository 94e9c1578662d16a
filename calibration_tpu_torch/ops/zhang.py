"""Zhang's closed-form intrinsics from planar homographies (port of
``calibration_tpu/ops/zhang.py``). Masked and batched: invalid views
contribute zero rows to the 2V x 6 system."""

from __future__ import annotations

import torch

from . import linalg


def _v_ij(h, i, j):
    """Zhang constraint row v_ij. h: (..., 3, 3)."""
    h0i, h1i, h2i = h[..., 0, i], h[..., 1, i], h[..., 2, i]
    h0j, h1j, h2j = h[..., 0, j], h[..., 1, j], h[..., 2, j]
    return torch.stack(
        [
            h0i * h0j,
            h0i * h1j + h1i * h0j,
            h1i * h1j,
            h0i * h2j + h2i * h0j,
            h1i * h2j + h2i * h1j,
            h2i * h2j,
        ],
        dim=-1,
    )


def normalize_hmtx(h):
    """Single-scalar per-H normalization, sign-consistent."""
    h = torch.where((h[..., 2, 2] < 0)[..., None, None], -h, h)
    h33 = h[..., 2, 2]
    nf = torch.linalg.norm(h, dim=(-2, -1))
    scale = torch.where(
        torch.abs(h33) > 1e-12, h33, torch.where(nf > 1e-12, nf, torch.ones_like(nf))
    )
    return h / scale[..., None, None]


def zhang_design_matrix(hs, mask=None):
    """Stack per-view rows [v12; v11 - v22], row-normalized.
    hs: (..., V, 3, 3); mask: optional (..., V). Returns (..., 2V, 6)."""
    hn = normalize_hmtx(hs)
    v12 = _v_ij(hn, 0, 1)
    v11 = _v_ij(hn, 0, 0)
    v22 = _v_ij(hn, 1, 1)

    def rownorm(r):
        s = torch.linalg.norm(r, dim=-1, keepdim=True)
        return r / torch.where(s > 0, s, torch.ones_like(s))

    rows = torch.stack([rownorm(v12), rownorm(v11 - v22)], dim=-2)  # (..., V, 2, 6)
    if mask is not None:
        # select, not multiply: an invalid view's H can be NaN
        rows = torch.where(mask[..., None, None].bool(), rows, torch.zeros_like(rows))
    return rows.reshape(rows.shape[:-3] + (2 * rows.shape[-3], 6))


def _bmtx_from_vec(b):
    """Symmetric B from the 6-vector [b11, b12, b22, b13, b23, b33]."""
    b11, b12, b22, b13, b23, b33 = b.unbind(-1)
    return torch.stack(
        [
            torch.stack([b11, b12, b13], -1),
            torch.stack([b12, b22, b23], -1),
            torch.stack([b13, b23, b33], -1),
        ],
        dim=-2,
    )


def _kmtx_from_dual_conic_try(bm):
    """Cholesky B = U^T U -> K = U^-1, normalized; returns (K, ok). A B that
    is not SPD gives a NaN factor -> ok = False."""
    low = linalg.cholesky(bm)
    u = low.transpose(-1, -2)
    ok = torch.all(torch.isfinite(low), dim=-1).all(dim=-1)
    eye = torch.eye(3, dtype=bm.dtype, device=bm.device).expand(u.shape)
    k = linalg.inv3(torch.where(ok[..., None, None], u, eye))
    k22 = k[..., 2, 2]
    big = torch.abs(k22) > 1e-15
    ok = ok & big & torch.all(torch.isfinite(k), dim=-1).all(dim=-1)
    k = k / torch.where(big, k22, torch.ones_like(k22))[..., None, None]
    # conventional K: positive focals
    flip = (k[..., 0, 0] <= 0) | (k[..., 1, 1] <= 0)
    k = torch.where(flip[..., None, None], -k, k)
    return k, ok


def kmtx_from_dual_conic(bvec):
    """Try B, then -B (b is homogeneous)."""
    bm = _bmtx_from_vec(bvec)
    bm = 0.5 * (bm + bm.transpose(-1, -2))
    k_pos, ok_pos = _kmtx_from_dual_conic_try(bm)
    k_neg, ok_neg = _kmtx_from_dual_conic_try(-bm)
    return torch.where(ok_pos[..., None, None], k_pos, k_neg), ok_pos | ok_neg


def zhang_intrinsics_from_hs(hs, mask=None):
    """K from >= 4 homographies. hs: (..., V, 3, 3); mask: optional (..., V).
    Returns (kmtx (..., 5), ok)."""
    vmtx = zhang_design_matrix(hs, mask)
    # the 2V x 6 system is small and less well-conditioned than DLT stacks:
    # full SVD rather than the gram shortcut
    bvec = linalg.smallest_singular_vector(vmtx, via_gram=False)
    k33, ok = kmtx_from_dual_conic(bvec)
    kvec = torch.stack(
        [k33[..., 0, 0], k33[..., 1, 1], k33[..., 0, 2], k33[..., 1, 2], k33[..., 0, 1]],
        dim=-1,
    )
    if mask is not None:
        ok = ok & (torch.sum(mask.to(torch.int64), dim=-1) >= 4)
    return kvec, ok
