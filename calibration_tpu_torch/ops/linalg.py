"""Small shared linear-algebra helpers (port of
``calibration_tpu/ops/linalg.py``) on ``torch.linalg``.

The reference's TPU workarounds are gone: no unrolled-Cholesky size set
(LAPACK/cuSOLVER Cholesky is exact and fast enough for bring-up) and no
self-healing inverse-power null vector (``torch.linalg.eigh`` of the gram is
reliable on CPU and GPU).

Failure semantics are kept: JAX's factorizations return NaN on a lane they
cannot handle (a Cholesky of a matrix that is not SPD, an SVD of a
non-finite matrix) and callers test for it (Zhang's B/-B try, the LM's
non-finite step rejection, the seed's ok flags), while ``torch.linalg``
raises. So every factorization here runs on lanes made safe first and
poisons the failed lanes' results with NaN: a raise never decides which
lanes are accepted.
"""

from __future__ import annotations

import torch


def inv3(m):
    """Closed-form 3x3 inverse via adjugate (kept: batched, no LU, and the
    reference's geometry code is written against it)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], -1),
            torch.stack([co10, co11, co12], -1),
            torch.stack([co20, co21, co22], -1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


def cholesky(a):
    """Lower Cholesky factor; lanes that are not SPD come back all-NaN
    (the ``jnp.linalg.cholesky`` contract)."""
    low, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None], torch.nan, low)


def cholesky_apply(low, rhs):
    """(L L^T)^-1 rhs for lower Cholesky factors low (..., n, n) and
    rhs (..., n, m), by two triangular solves, as LAPACK's potrs does (on
    the CPU the result is ``torch.cholesky_solve(rhs, low)``'s, bit for
    bit). A NaN factor (a lane that is not SPD) gives NaN.

    On CUDA a batched ``cholesky_solve`` runs MAGMA, which allocates and
    frees device memory on every call: an implicit synchronisation, and a
    call that a CUDA graph cannot capture. The triangular solves run
    cuBLAS's batched trsm, which does neither."""
    y = torch.linalg.solve_triangular(low, rhs, upper=False)
    return torch.linalg.solve_triangular(low.mT, y, upper=True)


def spd_solve(a, b):
    """Solve SPD systems via Cholesky (``cholesky_apply``). a: (..., n, n);
    b: (..., n) or (..., n, m). Non-SPD lanes give NaN."""
    if b.ndim == a.ndim:
        return cholesky_apply(cholesky(a), b)
    return cholesky_apply(cholesky(a), b[..., None])[..., 0]


def spd_inverse(a):
    """Inverse of SPD matrices via Cholesky: the factor applied to I
    (``cholesky_apply``). Non-SPD lanes give NaN. (``cholesky_inverse``
    raises on a zero pivot.)"""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(a.shape)
    return cholesky_apply(cholesky(a), eye)


def solve_llsq(a, b):
    """Least-squares solution x (..., N) of a (..., M, N) x = b (..., M),
    by ``torch.linalg.lstsq`` (the minimum-norm one on the CPU; on CUDA a
    QR solve, which needs full column rank)."""
    return torch.linalg.lstsq(a, b[..., None]).solution[..., 0]


def ridge_llsq(a, b, lam: float = 1e-10):
    """(A^T A + lam I)^-1 A^T b via Cholesky. a: (..., M, N); b: (..., M)."""
    n = a.shape[-1]
    ata = torch.einsum("...ki,...kj->...ij", a, a) + lam * torch.eye(n, dtype=a.dtype, device=a.device)
    atb = torch.einsum("...ki,...k->...i", a, b)
    return spd_solve(ata, atb)


def _finite_lanes(a):
    """(ok (...,), a with its non-finite lanes zeroed)."""
    ok = torch.isfinite(a).all(dim=-1).all(dim=-1)
    return ok, torch.where(ok[..., None, None], a, torch.zeros_like(a))


def _poison(ok, *outs):
    return tuple(
        torch.where(ok.reshape(ok.shape + (1,) * (o.ndim - ok.ndim)), o, torch.nan) for o in outs
    )


def svd(a, full_matrices: bool = True):
    """``torch.linalg.svd`` that gives NaN for a non-finite lane instead of
    raising."""
    ok, safe = _finite_lanes(a)
    return _poison(ok, *torch.linalg.svd(safe, full_matrices=full_matrices))


def eigh(a):
    """``torch.linalg.eigh`` that gives NaN for a non-finite lane instead of
    raising."""
    ok, safe = _finite_lanes(a)
    return _poison(ok, *torch.linalg.eigh(safe))


def det3(m):
    """Closed-form 3x3 determinant (no LU)."""
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def smallest_singular_vector(a, via_gram: bool = True):
    """Right singular vector of the smallest singular value of a (..., M, N).

    Zeroed rows do not perturb the result. ``via_gram`` takes the
    eigenvector of the smallest eigenvalue of the N x N gram A^T A (squares
    the condition number; Hartley-normalized DLT systems are far inside f64
    range); otherwise a full SVD. The sign is arbitrary: every caller
    normalizes it away.
    """
    m, n = a.shape[-2], a.shape[-1]
    if via_gram and m > n:
        g = a.transpose(-1, -2) @ a
        _, vecs = eigh(g)
        return vecs[..., :, 0]
    _, _, vt = svd(a)
    return vt[..., -1, :]


def min_singular_value(a):
    return torch.linalg.svdvals(a)[..., -1]
