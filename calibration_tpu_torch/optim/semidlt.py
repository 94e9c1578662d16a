"""Semi-DLT intrinsics: K and the per-view poses refined with the
distortion eliminated globally by variable projection, batched over
cameras (port of ``calibration_tpu/optim/semidlt.py``).

Parameters per camera: [K(5), quat_0..quat_V, t_0..t_V]. The residual is
the inner linear distortion fit's residual over ALL views at once, so one
Huber block per camera. The distortion coefficients are recovered after
the solve by re-running the inner fit. The dense ``lm_core`` solves, with
its own forward-mode Jacobian.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import distortion as dist
from ..ops import planarpose, se3
from . import blocks, lm
from .core import OptimResult, TerminationType, brief_report
from .intrinsics import IntrinsicsOptimOptions, make_manifold


def _fixed_arrays(opts: IntrinsicsOptimOptions, d: int, *, device=None):
    """(fixed mask (D,) bool, fixed values (D,) float64) of
    ``fixed_distortion_indices`` / ``_values``; ValueError on an index
    outside [0, D)."""
    fixed_mask = np.zeros((d,), bool)
    fixed_vals = np.zeros((d,), np.float64)
    for i, idx in enumerate(opts.fixed_distortion_indices):
        if idx < 0 or idx >= d:
            raise ValueError("Fixed distortion index out of range")
        fixed_mask[idx] = True
        if i < len(opts.fixed_distortion_values):
            fixed_vals[idx] = opts.fixed_distortion_values[i]
    return torch.as_tensor(fixed_mask, device=device), torch.as_tensor(fixed_vals, device=device)


def _normalized_obs(quats, trans, obj_xy):
    """Per-view target points (B, V, N, 2) -> normalized camera coords under
    the poses quats (B, V, 4), trans (B, V, 3)."""
    rot = se3.quat_to_rotmat(quats)
    pts = torch.cat([obj_xy, torch.zeros_like(obj_xy[..., :1])], dim=-1)
    pc3 = torch.einsum("bvij,bvnj->bvni", rot, pts) + trans[..., None, :]
    return pc3[..., :2] / pc3[..., 2:3]


def _vp_fit(x, obj_xy, img_uv, mask, num_radial, fixed_mask, fixed_vals):
    """(kmtx, quats, trans, the inner fit's (coeffs, residuals, ok)) of
    parameters x (B, 5 + 7V), every view's observations in one fit."""
    b, v = obj_xy.shape[:2]
    kmtx, quats, trans = blocks.unpack_intr_quats_trans(x, 5, v)
    xy = _normalized_obs(quats, trans, obj_xy).reshape(b, -1, 2)
    fit = dist.fit_distortion_full(
        xy, img_uv.reshape(b, -1, 2), kmtx, num_radial, mask=mask.reshape(b, -1), fixed_mask=fixed_mask,
        fixed_values=fixed_vals,
    )
    return kmtx, quats, trans, fit


def optimize_intrinsics_semidlt_device(
    obj_xy, img_uv, init_kmtx, mask=None, opts: IntrinsicsOptimOptions | None = None
):
    """Refine B cameras on the tensors' device: the reference's parameters,
    in its order, with a leading B axis (the reference's takes one camera).
    obj_xy/img_uv: (B, V, N, 2); init_kmtx: (B, 5); mask: optional
    (B, V, N). The poses start from the per-view planar-pose DLT under the
    initial K; skew stays frozen unless ``opts.optimize_skew``, and
    ``opts.bounds`` boxes K.

    Returns (LMOutput, kmtx (B, 5), distortion (B, num_radial + 2), poses
    (B, V, 4, 4), view_errors (B, V), cov (B, n, n) unscaled, cov_ok (B,),
    ssr (B,)) with n = 5 + 7V.
    """
    opts = opts or IntrinsicsOptimOptions()
    b, v, n = obj_xy.shape[:3]
    dtype, device = obj_xy.dtype, obj_xy.device
    d = opts.num_radial + 2
    if mask is None:
        mask = torch.ones((b, v, n), dtype=torch.bool, device=device)
    fixed_mask, fixed_vals = _fixed_arrays(opts, d, device=device)

    poses0 = planarpose.estimate_planar_pose(obj_xy, img_uv, init_kmtx[:, None, :].expand(b, v, 5), mask)
    quats0, trans0 = blocks.poses_to_quat_tran(poses0)
    x0 = blocks.pack_intr_quats_trans(init_kmtx, quats0, trans0)
    manifold = make_manifold(5, v)

    free = torch.ones((5 + 7 * v,), dtype=torch.bool, device=device)
    if not opts.optimize_skew:
        free[4] = False

    lower = upper = None
    if opts.bounds is not None:
        bd = opts.bounds
        rest = torch.full((7 * v,), torch.inf, dtype=dtype, device=device)
        lower = torch.cat([torch.tensor([bd.fx_min, bd.fy_min, bd.cx_min, bd.cy_min, bd.skew_min], dtype=dtype,
                                        device=device), -rest])
        upper = torch.cat([torch.tensor([bd.fx_max, bd.fy_max, bd.cx_max, bd.cy_max, bd.skew_max], dtype=dtype,
                                        device=device), rest])

    def res_fn(x, obj, uv, m):
        return _vp_fit(x, obj, uv, m, opts.num_radial, fixed_mask, fixed_vals)[3][1]

    data = (obj_xy, img_uv, mask)
    # no jac_fn: lm_core's own ``vmap(jacfwd)``, which beat
    # ``lm.dual_jacobian_fn``, one evaluation on dual numbers, on the semi-DLT
    # cell once its retraction took each run of quaternions at once (H100
    # 80GB HBM3 at 700 W, 3 interleaved warm calls each: medians 0.575 vs
    # 0.690 s; before, 1.435 vs 1.319 s), costs equal to 8e-15
    out = lm.lm_core(
        res_fn, x0, manifold, data=data, options=opts.core, free_mask=free, num_blocks=1, lower=lower, upper=upper,
    )
    if opts.core.compute_covariance:
        cov, cov_ok = lm.covariance(
            res_fn, out.x, manifold, data=data, free_mask=free, num_blocks=1, huber_delta=opts.core.huber_delta,
        )
    else:
        n_amb = manifold.ambient_dim
        cov = torch.zeros((b, n_amb, n_amb), dtype=dtype, device=device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=device)

    kmtx, quats_f, trans_f, (coeffs, res, _) = _vp_fit(
        out.x, obj_xy, img_uv, mask, opts.num_radial, fixed_mask, fixed_vals
    )
    res_v = res.reshape(b, v, 2 * n)
    cnt = torch.clamp(torch.sum(mask.to(dtype), dim=-1), min=1.0)
    view_errors = torch.sqrt(torch.sum(res_v * res_v, dim=-1) / (2.0 * cnt))
    poses = blocks.quat_tran_to_poses(quats_f, trans_f)
    return out, kmtx, coeffs, poses, view_errors, cov, cov_ok, torch.sum(res * res, dim=-1)


@dataclasses.dataclass
class SemiDltResult:
    core: OptimResult
    kmtx: np.ndarray  # (5,)
    distortion: np.ndarray  # (num_radial + 2,)
    c_se3_t: np.ndarray  # (V, 4, 4)
    view_errors: np.ndarray


def optimize_intrinsics_semidlt(
    obj_xy, img_uv, initial_guess, mask=None, opts: IntrinsicsOptimOptions | None = None
):
    """Host-facing wrapper for ONE camera, a B = 1 call of
    ``optimize_intrinsics_semidlt_device``. obj_xy/img_uv: (V, N, 2) with
    V >= 4; initial_guess: (5,); mask: optional (V, N); all tensors on one
    device. The covariance is scaled by ssr / (m - n), m the valid residual
    rows and n = 5 + 7V."""
    opts = opts or IntrinsicsOptimOptions()
    if obj_xy.shape[0] < 4:
        raise ValueError("Insufficient views for calibration (at least 4 required).")
    out, kmtx, coeffs, poses, view_errors, cov, cov_ok, ssr = optimize_intrinsics_semidlt_device(
        obj_xy[None], img_uv[None], initial_guess[None], mask=None if mask is None else mask[None], opts=opts
    )
    m = 2 * (int(mask.bool().sum()) if mask is not None else obj_xy.shape[0] * obj_xy.shape[1])
    ambient = 5 + 7 * obj_xy.shape[0]
    cov_scaled = cov[0].cpu().numpy() * (float(ssr[0]) / max(1, m - ambient))
    core = OptimResult(
        success=bool(out.success[0]),
        covariance=cov_scaled if (opts.core.compute_covariance and bool(cov_ok[0])) else None,
        final_cost=float(out.cost[0]),
        iterations=int(out.iterations[0]),
        termination=TerminationType(int(out.termination[0])),
        initial_cost=float(out.initial_cost[0]),
    )
    core.report = brief_report(core)
    return SemiDltResult(
        core=core, kmtx=kmtx[0].cpu().numpy(), distortion=coeffs[0].cpu().numpy(), c_se3_t=poses[0].cpu().numpy(),
        view_errors=view_errors[0].cpu().numpy(),
    )
