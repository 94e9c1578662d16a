"""A plain batched Levenberg-Marquardt solver with Huber loss blocks.

Each lane minimises 0.5 * sum_k rho(|r_k|^2) over its parameters, with
r_k the k-th loss block of ``residual(x, *lane_data)`` ((K, m) per lane)
and rho Huber's loss with threshold ``huber`` (rho(s) = s up to huber^2,
2 huber sqrt(s) - huber^2 beyond), the same cost the program's solvers
minimise. The Jacobian is forward-mode autodiff (``torch.func``); steps
solve the Jacobi-scaled, damped Gauss-Newton system of the robust cost.
Lanes run in chunks, so a large batch fits in memory.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap


def block_weights(r, huber):
    """IRLS weights (B, K) and the robust cost (B,) of residual blocks
    r (B, K, m)."""
    s = (r * r).sum(-1)
    if huber <= 0:
        return torch.ones_like(s), 0.5 * s.sum(-1)
    d2 = huber * huber
    out = s > d2
    root = torch.sqrt(torch.clamp(s, min=1e-300 if s.dtype == torch.float64 else 1e-30))
    w = torch.where(out, huber / root, torch.ones_like(s))
    rho = torch.where(out, 2.0 * huber * root - d2, s)
    return w, 0.5 * rho.sum(-1)


def cost(residual, x, data, huber):
    """The robust cost (B,) at x (B, P)."""
    return block_weights(vmap(residual)(x, *data), huber)[1]


def gram(residual, x, data, huber, free, exact=False):
    """(H (B, P, P), g (B, P), cost (B,)) of the Gauss-Newton model at x;
    frozen parameters (free false) get zero rows and columns. H is the
    IRLS matrix J^T W J, the one the program's covariance inverts, or with
    ``exact`` the Gauss-Newton matrix of the robust cost itself (Triggs'
    correction: a block past the threshold loses its curvature along its
    own residual), whose steps converge fast in the linear Huber range."""
    r = vmap(residual)(x, *data)
    j = vmap(jacfwd(residual))(x, *data)  # (B, K, m, P)
    w, c = block_weights(r, huber)
    j = j * free[:, None, None, :]
    jw = j * w[..., None, None]
    h = torch.einsum("bkmi,bkmj->bij", jw, j)
    g = torch.einsum("bkmi,bkm->bi", jw, r)
    if exact and huber > 0:
        s = (r * r).sum(-1)
        jr = torch.einsum("bkmi,bkm->bki", j, r)
        out = (s > huber * huber).to(x.dtype)
        h = h - torch.einsum("bk,bki,bkj->bij", out * w / torch.clamp(s, min=torch.finfo(x.dtype).tiny), jr, jr)
    return h, g, c


def _solve_chunk(residual, x, data, huber, free, iters, tol):
    b, p = x.shape
    lam = torch.full((b,), 1e-4, dtype=x.dtype, device=x.device)
    eye = torch.eye(p, dtype=x.dtype, device=x.device)
    done = torch.zeros((b,), dtype=torch.bool, device=x.device)
    h, g, c = gram(residual, x, data, huber, free, exact=True)
    for _ in range(iters):
        d = torch.sqrt(torch.clamp(h.diagonal(dim1=-2, dim2=-1), min=0.0))
        d = torch.where(free > 0, torch.clamp(d, min=1e-12), torch.ones_like(d))
        hs = h / (d[:, :, None] * d[:, None, :]) + (1.0 - free)[:, :, None] * eye
        gs = g / d
        step = -torch.linalg.solve(hs + lam[:, None, None] * eye, gs[..., None])[..., 0] / d
        step = torch.where(done[:, None], torch.zeros_like(step), step * free)
        x_new = x + step
        c_new = cost(residual, x_new, data, huber)
        accept = (c_new < c) & ~done
        done = done | (accept & (c - c_new <= tol * c)) | (~accept & (lam > 1e12))
        lam = torch.where(accept, lam * 0.3, lam * 10.0).clamp(1e-12, 1e16)
        x = torch.where(accept[:, None], x_new, x)
        if bool(accept.any()):
            h_a, g_a, c_a = gram(residual, x, data, huber, free, exact=True)
            h = torch.where(accept[:, None, None], h_a, h)
            g = torch.where(accept[:, None], g_a, g)
            c = torch.where(accept, c_a, c)
        if bool(done.all()):
            break
    return x, c


def solve(residual, x0, data, huber, free, iters=60, tol=None, chunk=64):
    """Minimise each lane's robust cost from x0 (B, P); ``data`` is a tuple
    of per-lane tensors (B, ...); ``free`` (P,) or (B, P) marks the
    parameters that move. A lane stops once an accepted step lowers its
    cost by at most ``tol`` relative (default: four ulps of the dtype).
    Returns (x (B, P), cost (B,))."""
    tol = 4.0 * torch.finfo(x0.dtype).eps if tol is None else tol
    free = free.to(x0.dtype).expand(x0.shape).contiguous()
    xs, cs = [], []
    for lo in range(0, x0.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        x, c = _solve_chunk(residual, x0[sl], tuple(d[sl] for d in data), huber, free[sl], iters, tol)
        xs.append(x)
        cs.append(c)
    return torch.cat(xs), torch.cat(cs)


def marginal_variances(residual, x, data, huber, free, index, chunk=64):
    """Diagonal of the inverse IRLS Gauss-Newton matrix at x, restricted to
    the parameters ``index``: their variances up to the residual scale, as
    the program's covariance (J^T W J)^-1 gives them. (B, len(index))."""
    free = free.to(x.dtype).expand(x.shape).contiguous()
    out = []
    for lo in range(0, x.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        h, _, _ = gram(residual, x[sl], tuple(d[sl] for d in data), huber, free[sl])
        f = free[sl]
        d = torch.where(f > 0, torch.sqrt(torch.clamp(h.diagonal(dim1=-2, dim2=-1), min=1e-300)), torch.ones_like(f))
        eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
        hs = h / (d[:, :, None] * d[:, None, :]) + (1.0 - f)[:, :, None] * eye
        inv = torch.linalg.inv(hs) / (d[:, :, None] * d[:, None, :])
        out.append(inv.diagonal(dim1=-2, dim2=-1)[:, index])
    return torch.cat(out)
