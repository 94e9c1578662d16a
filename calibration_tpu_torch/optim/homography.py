"""Non-linear homography refinement, batched over problems (port of
``calibration_tpu/optim/homography.py``): 8 parameters with H22 == 1,
per-point transfer-error residuals, one Huber block per point, through the
dense ``lm_core`` with forward-mode Jacobians.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import homography as H
from . import lm
from .core import OptimOptions, OptimResult, TerminationType, brief_report
from .manifold import ProductManifold, euclid

_MANIFOLD = ProductManifold([euclid(8)])


def params_to_h(p):
    """(..., 8) -> (..., 3, 3) with H22 = 1."""
    ones = torch.ones(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
    return torch.cat([p, ones], dim=-1).reshape(p.shape[:-1] + (3, 3))


def h_to_params(hm):
    hm = hm / hm[..., 2:3, 2:3]
    return hm.reshape(hm.shape[:-2] + (9,))[..., :8]


def _residual(p, obj_xy, img_uv, mask):
    """(B, 2N) masked transfer residuals, rows interleaved (u, v)."""
    uv_hat = H.apply_homography(params_to_h(p), obj_xy)
    r = (uv_hat - img_uv) * mask[..., None]
    return r.reshape(r.shape[:-2] + (-1,))


def _problem(obj_xy, mask):
    n = obj_xy.shape[-2]
    if mask is None:
        mask = torch.ones(obj_xy.shape[:-1], dtype=obj_xy.dtype, device=obj_xy.device)
    mask = mask.to(obj_xy.dtype)
    # m counts valid rows only (masked rows are zeroed, not observations)
    m = 2.0 * torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return mask, np.repeat(np.arange(n), 2), n, m


def homography_covariance_device(hm, obj_xy, img_uv, mask=None, options=OptimOptions()):
    """Covariance (B, 8, 8) of the 8 free parameters at solved homographies
    hm (B, 3, 3), scaled by ssr / (m - 8): the deferred final pass of the
    phased batch. Returns (cov, cov_ok (B,))."""
    mask, block_ids, n, m = _problem(obj_xy, mask)
    return lm.covariance(
        _residual, h_to_params(hm), _MANIFOLD, data=(obj_xy, img_uv, mask), scale_by_variance=True,
        num_residuals=m, block_ids=block_ids, num_blocks=n, huber_delta=options.huber_delta,
    )


def optimize_homography_device(init_h, obj_xy, img_uv, mask=None, options=OptimOptions()):
    """Refine B homographies on the tensors' device. init_h: (B, 3, 3);
    obj_xy/img_uv: (B, N, 2); mask: (B, N). Returns (LMOutput, H (B, 3, 3),
    cov (B, 8, 8), cov_ok (B,))."""
    mask, block_ids, n, _ = _problem(obj_xy, mask)
    out = lm.lm_core(
        _residual, h_to_params(init_h), _MANIFOLD, data=(obj_xy, img_uv, mask), options=options,
        block_ids=block_ids, num_blocks=n,
    )
    if options.compute_covariance:
        cov, cov_ok = homography_covariance_device(params_to_h(out.x), obj_xy, img_uv, mask, options)
    else:
        # skip the extra linearization + 8x8 solve when covariance is off
        b = obj_xy.shape[0]
        cov = torch.zeros((b, 8, 8), dtype=obj_xy.dtype, device=obj_xy.device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=obj_xy.device)
    return out, params_to_h(out.x), cov, cov_ok


@dataclasses.dataclass
class OptimizeHomographyResult:
    core: OptimResult
    homography: np.ndarray


def optimize_homography(obj_xy, img_uv, init_h, options: OptimOptions = OptimOptions(), mask=None):
    """Host-facing wrapper for ONE problem, a B = 1 call of
    ``optimize_homography_device``. obj_xy/img_uv: (N, 2); init_h: (3, 3);
    mask: (N,); all tensors on one device."""
    if obj_xy.shape[0] < 4:
        raise ValueError("At least 4 correspondences are required.")
    out, hm, cov, cov_ok = optimize_homography_device(
        init_h[None], obj_xy[None], img_uv[None], mask=None if mask is None else mask[None], options=options
    )
    core = OptimResult(
        success=bool(out.success[0]),
        covariance=cov[0].cpu().numpy() if (options.compute_covariance and bool(cov_ok[0])) else None,
        final_cost=float(out.cost[0]),
        iterations=int(out.iterations[0]),
        termination=TerminationType(int(out.termination[0])),
        initial_cost=float(out.initial_cost[0]),
    )
    core.report = brief_report(core)
    return OptimizeHomographyResult(core=core, homography=hm[0].cpu().numpy())
