"""Planar pose refinement with variable-projection distortion elimination,
batched over problems (port of ``calibration_tpu/optim/planarpose.py``).

The pose is a 6-vector (angle-axis + translation, the pose6 packing). Each
residual evaluation transforms the target points, solves the linear
distortion system (``models.distortion.fit_distortion_full``) and returns
its residuals: the distortion never enters the LM state. One Huber block
per problem; the dense ``lm_core`` solves, with the dual-number Jacobian
``lm.dual_jacobian_fn``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import distortion as dist
from ..ops import se3
from . import lm
from .core import OptimOptions, OptimResult, TerminationType, brief_report
from .manifold import ProductManifold, euclid

_MANIFOLD = ProductManifold([euclid(6)])


def _normalized_obs(pose6, obj_xy):
    """Target points (B, N, 2) -> normalized camera coords under the poses
    (B, 6)."""
    pts = torch.cat([obj_xy, torch.zeros_like(obj_xy[..., :1])], dim=-1)
    pc = se3.se3_apply(se3.se3_exp(pose6)[..., None, :, :], pts)
    return pc[..., :2] / pc[..., 2:3]


def _vp_residual(pose6, obj_xy, img_uv, kmtx, mask, num_radial):
    _, res, _ = dist.fit_distortion_full(_normalized_obs(pose6, obj_xy), img_uv, kmtx, num_radial, mask=mask)
    return res


def optimize_planar_pose_device(
    init_pose, obj_xy, img_uv, kmtx, num_radial=2, mask=None, options=OptimOptions()
):
    """Refine B planar poses on the tensors' device: the reference's
    parameters, in its order, with a leading B axis (the reference's takes
    one problem). init_pose: (B, 4, 4); obj_xy/img_uv: (B, N, 2); kmtx:
    (B, 5); mask: optional (B, N).

    Returns (LMOutput, pose (B, 4, 4), distortion coefficients
    (B, num_radial + 2), cov (B, 6, 6), cov_ok (B,), reprojection RMS
    (B,)). The RMS and the variance-scaled covariance count valid rows
    only.
    """
    b, n = obj_xy.shape[0], obj_xy.shape[-2]
    dtype, device = obj_xy.dtype, obj_xy.device
    mask = torch.ones((b, n), dtype=dtype, device=device) if mask is None else mask.to(dtype)
    pose6_0 = se3.se3_log(init_pose)

    def res_fn(p, obj, uv, k, m):
        return _vp_residual(p, obj, uv, k, m, num_radial)

    data = (obj_xy, img_uv, kmtx, mask)
    # the VarPro residual's Jacobian on dual numbers, one evaluation, beat
    # lm_core's own ``vmap(jacfwd)`` on the planar-pose cell (H100 80GB HBM3
    # at 700 W, medians of 7 interleaved warm calls: 0.176 vs 0.218 s and
    # 0.179 vs 0.213 s in two runs), costs equal to 3e-14
    jac = lm.dual_jacobian_fn(res_fn, _MANIFOLD)
    out = lm.lm_core(res_fn, pose6_0, _MANIFOLD, data=data, options=options, num_blocks=1, jac_fn=jac)

    coeffs, res, _ = dist.fit_distortion_full(_normalized_obs(out.x, obj_xy), img_uv, kmtx, num_radial, mask=mask)
    # m counts the valid rows (the fit zeroes the masked ones)
    m = 2.0 * torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    rms = torch.sqrt(torch.sum(res * res, dim=-1) / m)
    if options.compute_covariance:
        cov, cov_ok = lm.covariance(
            res_fn, out.x, _MANIFOLD, data=data, scale_by_variance=True, num_residuals=m, num_blocks=1,
            huber_delta=options.huber_delta, jac_fn=jac,
        )
    else:
        cov = torch.zeros((b, 6, 6), dtype=dtype, device=device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=device)
    return out, se3.se3_exp(out.x), coeffs, cov, cov_ok, rms


@dataclasses.dataclass
class PlanarPoseResult:
    core: OptimResult
    pose: np.ndarray
    distortion: np.ndarray
    reprojection_error: float


@dataclasses.dataclass(frozen=True)
class PlanarPoseOptions:
    """The reference's PlanarPoseOptions, field for field and in its order."""

    core: OptimOptions = dataclasses.field(default_factory=OptimOptions)
    num_radial: int = 2


def optimize_planar_pose(obj_xy, img_uv, kmtx, init_pose, opts: PlanarPoseOptions = None, mask=None):
    """Host-facing wrapper for ONE problem, a B = 1 call of
    ``optimize_planar_pose_device``. obj_xy/img_uv: (N, 2); kmtx: (5,);
    init_pose: (4, 4); mask: optional (N,); all tensors on one device."""
    opts = opts or PlanarPoseOptions()
    out, pose, coeffs, cov, cov_ok, rms = optimize_planar_pose_device(
        init_pose[None], obj_xy[None], img_uv[None], kmtx[None], num_radial=opts.num_radial,
        mask=None if mask is None else mask[None], options=opts.core,
    )
    core = OptimResult(
        success=bool(out.success[0]),
        covariance=cov[0].cpu().numpy() if (opts.core.compute_covariance and bool(cov_ok[0])) else None,
        final_cost=float(out.cost[0]),
        iterations=int(out.iterations[0]),
        termination=TerminationType(int(out.termination[0])),
        initial_cost=float(out.initial_cost[0]),
    )
    core.report = brief_report(core)
    return PlanarPoseResult(
        core=core, pose=pose[0].cpu().numpy(), distortion=coeffs[0].cpu().numpy(), reprojection_error=float(rms[0])
    )
