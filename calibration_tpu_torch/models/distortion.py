"""Brown-Conrady lens distortion: the forward map, its fixed-point inverse
and the linear (variable-projection) coefficient fits (port of
``calibration_tpu/models/distortion.py``).

Coefficients are ``[k1..kn, p1, p2]``: n radial terms, then two tangential.
The fits are the inner solve of the variable-projection residuals: a
masked normal-equation solve of fixed shape, batched over leading dims and
differentiable in forward mode, so the LM engine can take its Jacobian.
"""

from __future__ import annotations

import torch

from . import camera_matrix as cm

MIN_FIT_OBSERVATIONS = 8
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


def _build_design(xy, uv, kmtx, num_radial):
    """The distortion design matrix (..., 2N, D) and right-hand side
    (..., 2N), rows interleaved (u, v) per observation. kmtx (..., 5)
    pairs with xy's leading dims."""
    fx, fy, cx, cy, skew = (kmtx[..., i, None] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y

    res_u = uv[..., 0] - (fx * x + skew * y + cx)
    res_v = uv[..., 1] - (fy * y + cy)

    cols_u = []
    cols_v = []
    rpow = r2
    for _ in range(num_radial):
        cols_u.append(fx * x * rpow + skew * y * rpow)
        cols_v.append(fy * y * rpow)
        rpow = rpow * r2
    # tangential p1, p2
    cols_u.append(fx * (2.0 * x * y) + skew * (r2 + 2.0 * y * y))
    cols_v.append(fy * (r2 + 2.0 * y * y))
    cols_u.append(fx * (r2 + 2.0 * x * x) + skew * (2.0 * x * y))
    cols_v.append(fy * (2.0 * x * y))

    a = torch.stack([torch.stack(cols_u, dim=-1), torch.stack(cols_v, dim=-1)], dim=-2)  # (..., N, 2, D)
    b = torch.stack([res_u, res_v], dim=-1)  # (..., N, 2)
    return a.reshape(a.shape[:-3] + (-1, num_radial + 2)), b.reshape(b.shape[:-2] + (-1,))


def fit_distortion_full(
    xy,
    uv,
    kmtx,
    num_radial: int = 2,
    mask=None,
    fixed_mask=None,
    fixed_values=None,
    ridge: float = 0.0,
):
    """Linear least-squares distortion fit, masked and batched.

    Args:
      xy: (..., N, 2) normalized undistorted coordinates.
      uv: (..., N, 2) observed distorted pixel coordinates.
      kmtx: (..., 5) intrinsics (or (5,) for every lane).
      num_radial: radial coefficient count; D = num_radial + 2.
      mask: optional (..., N) observation validity; masked rows are zeroed
        out of the system (exactly equivalent to dropping them).
      fixed_mask: optional (D,) bool, coefficients pinned to
        ``fixed_values`` and eliminated from the solve (their rows and
        columns become identity rows, the rhs is adjusted).
      fixed_values: (D,) values of the pinned coefficients (default 0).
      ridge: Tikhonov damping of the normal equations (0: exact LSQ).

    Returns:
      (coeffs (..., D), residuals (..., 2N), ok (...,)): residuals are
      ``A @ coeffs - b`` with masked rows zero; ok is False with fewer than
      8 valid observations or a non-finite solution.
    """
    from ..ops import linalg  # imported when called: ``ops`` imports ``models``

    n = xy.shape[-2]
    d = num_radial + 2
    a, b = _build_design(xy, uv, kmtx, num_radial)
    dtype, device = a.dtype, a.device
    if mask is not None:
        m2 = torch.repeat_interleave(mask.to(dtype), 2, dim=-1)
        a = a * m2[..., :, None]
        b = b * m2
        count = torch.sum(mask.to(torch.int64), dim=-1)
    else:
        count = torch.full(a.shape[:-2], n, dtype=torch.int64, device=device)

    if fixed_mask is None:
        fixed_mask = torch.zeros((d,), dtype=torch.bool, device=device)
    fixed_mask = torch.as_tensor(fixed_mask, device=device).bool()
    if fixed_values is None:
        fixed_values = torch.zeros((d,), dtype=dtype, device=device)
    fixed_values = torch.as_tensor(fixed_values, dtype=dtype, device=device) * fixed_mask

    b_adj = b - torch.einsum("...nj,...j->...n", a, fixed_values)
    free = (~fixed_mask).to(dtype)
    ata = torch.einsum("...ni,...nj->...ij", a, a)
    atb = torch.einsum("...ni,...n->...i", a, b_adj)
    # pinned rows/cols become identity rows: their delta solves to exactly 0
    eye = torch.eye(d, dtype=dtype, device=device)
    sys = ata * (free[..., :, None] * free[..., None, :]) + torch.diag_embed(1.0 - free) + ridge * eye
    alpha = torch.where(fixed_mask, fixed_values, linalg.spd_solve(sys, atb * free))
    residuals = torch.einsum("...ij,...j->...i", a, alpha) - b
    ok = (count >= MIN_FIT_OBSERVATIONS) & torch.isfinite(alpha).all(dim=-1)
    return alpha, residuals, ok


def fit_distortion(xy, uv, kmtx, num_radial: int = 2, **kw):
    """Alias of ``fit_distortion_full`` (the reference's ``fit_distortion``)."""
    return fit_distortion_full(xy, uv, kmtx, num_radial, **kw)


def invert_brown_conrady(forward, num_samples: int = 21, lim: float = 1.0):
    """Inverse coefficients fitted over a grid on [-lim, lim]^2 with the
    identity K. ``forward``: (..., D). Returns (..., D) inverse
    coefficients, zero where the fit fails."""
    num_radial = forward.shape[-1] - 2
    g = torch.linspace(-lim, lim, num_samples, dtype=forward.dtype, device=forward.device)
    gx, gy = torch.meshgrid(g, g, indexing="ij")
    und = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (G, 2)
    dst = apply_distortion(und, forward[..., None, :])
    kmtx = torch.tensor([1.0, 1.0, 0.0, 0.0, 0.0], dtype=forward.dtype, device=forward.device)
    # observations: x, y the distorted points; u, v the undistorted ones
    coeffs, _, ok = fit_distortion_full(dst, und.expand(dst.shape), kmtx, num_radial)
    return torch.where(ok[..., None], coeffs, torch.zeros_like(coeffs))


def fit_distortion_dual(xy, uv, kmtx, num_radial: int = 2, mask=None, **kw):
    """Forward and inverse coefficient sets fitted from data.

    Returns (forward, inverse, forward residuals, ok)."""
    fwd, res, ok_f = fit_distortion_full(xy, uv, kmtx, num_radial, mask=mask, **kw)
    k = kmtx[..., None, :]
    inv, _, ok_i = fit_distortion_full(cm.normalize(k, uv), cm.denormalize(k, xy), kmtx, num_radial, mask=mask, **kw)
    return fwd, inv, res, ok_f & ok_i
