"""Hand-eye bundle adjustment, batched over rigs (port of
``calibration_tpu/optim/bundle.py``; reference: src/estimation/optim/
bundle.cpp + residuals/bundleresidual.h).

Parameter layout per rig: [intr_0..intr_C, g_quat_0.., g_tra_0..,
b_quat, b_tra] (BundleBlocks::get_param_blocks). Each observation o is one
view of the planar target by camera ``cam_idx[o]`` at the constant gripper
pose b_se3_g[o]; its points project through c_se3_t = (g_se3_c)^-1
(b_se3_g)^-1 b_se3_t. One Huber block per observation. The intrinsics, the
hand-eye poses and the target pose are each free or frozen by the options;
fx, fy get a zero lower bound when the intrinsics are free.

Any registry camera model projects the points. For the pinhole model the
Jacobian is the analytic ``_residual_jac_pinhole`` by default (equal to
jacfwd to 1e-10); ``analytic_jac=False``, and any other model, differentiate
the residual by forward-mode autodiff (``torch.func.vmap`` of ``jacfwd``).
The dense ``lm_core`` solves.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..models import pinhole
from ..models.registry import PINHOLE, SPECS
from ..ops import se3
from . import blocks, lm
from .core import OptimOptions, OptimResult, TerminationType, brief_report, check_ported, check_precision
from .manifold import ProductManifold, euclid, quat

# the camera models the bundle solvers take (check_ported): every registry
# model
MODELS = tuple(m.name for m in SPECS)


@dataclasses.dataclass(frozen=True)
class BundleOptions:
    """The reference's BundleOptions, field for field and in its order, so
    JSON configs and reports (which write positional ``field_N`` keys)
    match."""

    core: OptimOptions = dataclasses.field(default_factory=OptimOptions)
    optimize_intrinsics: bool = False
    optimize_skew: bool = False
    optimize_target_pose: bool = True
    optimize_hand_eye: bool = True


def make_manifold(pc: int, c: int) -> ProductManifold:
    return ProductManifold([euclid(pc)] * c + [quat()] * c + [euclid(3)] * c + [quat(), euclid(3)])


def unpack(x, pc, c):
    """(..., C*pc + 7C + 7) -> (intr (..., C, pc), g quats (..., C, 4),
    g trans (..., C, 3), target quat (..., 4), target tran (..., 3))."""
    lead = x.shape[:-1]
    intr, gq, gt, bq, bt = torch.split(x, [c * pc, 4 * c, 3 * c, 4, 3], dim=-1)
    return intr.reshape(lead + (c, pc)), gq.reshape(lead + (c, 4)), gt.reshape(lead + (c, 3)), bq, bt


def _per_obs(t, cam_idx):
    """Camera rows (B, C, ...) -> each observation's camera's row
    (B, O, ...)."""
    idx = cam_idx.reshape(cam_idx.shape + (1,) * (t.ndim - 2)).expand(cam_idx.shape + t.shape[2:])
    return torch.gather(t, 1, idx)


def _points(obj_xy):
    return torch.cat([obj_xy, torch.zeros_like(obj_xy[..., :1])], dim=-1)


def _residual(x, obj_xy, img_uv, mask, b_se3_g, cam_idx, pc, c, model=PINHOLE):
    """Masked pixel residuals (B, O*N*2) through ``model``, rows ordered
    (observation, point, u/v). x: (B, C*pc + 7C + 7); obj_xy/img_uv:
    (B, O, N, 2); mask (B, O, N); b_se3_g (B, O, 4, 4); cam_idx (B, O)
    int."""
    intr, gq, gt, bq, bt = unpack(x, pc, c)
    g_se3_c = blocks.quat_tran_to_poses(gq, gt)  # (B, C, 4, 4)
    b_se3_t = se3.make_se3(se3.quat_to_rotmat(bq), bt)  # (B, 4, 4)
    c_se3_b = se3.se3_inverse(_per_obs(g_se3_c, cam_idx)) @ se3.se3_inverse(b_se3_g)  # (B, O, 4, 4)
    c_se3_t = c_se3_b @ b_se3_t[:, None]
    pc3 = torch.einsum("boij,bonj->boni", se3.rot(c_se3_t), _points(obj_xy)) + se3.tra(c_se3_t)[:, :, None, :]
    uv_hat = model.project(_per_obs(intr, cam_idx)[:, :, None, :], pc3)
    r = (uv_hat - img_uv) * mask[..., None]
    return r.reshape(r.shape[0], -1)


def _residual_jac_pinhole(x, obj_xy, img_uv, mask, b_se3_g, cam_idx, pc, c):
    """Analytic tangent Jacobian of ``_residual`` for the pinhole model:
    (B, O*N*2, C*pc + 6C + 6), columns in the ``make_manifold`` tangent
    layout [intr_0..intr_C, omega_g x C, t_g x C, omega_b (3), t_b (3)].

    Chain rule of project(intr_c, R_g^T (R_bo^T (R_b exp(omega_b^) p + t_b
    - t_bo) - t_g)) with right-multiplied quaternion retractions on g_se3_c
    and b_se3_t: d p_c / d omega_g = [p_c]_x, d p_c / d t_g = -R_g^T,
    d p_c / d omega_b = -R_cb R_b [p]_x and d p_c / d t_b = R_cb with
    R_cb = R_g^T R_bo^T. Camera c's rows touch only camera c's columns.
    Assumes the fx/fy bounds are inactive, as the reference does.
    """
    intr, gq, gt, bq, bt = unpack(x, pc, c)
    rb = se3.quat_to_rotmat(bq)[:, None]  # (B, 1, 3, 3) base <- target
    rbo = se3.rot(b_se3_g)  # (B, O, 3, 3) base <- gripper
    tbo = se3.tra(b_se3_g)
    rg_o = _per_obs(se3.quat_to_rotmat(gq), cam_idx)  # (B, O, 3, 3) gripper <- camera
    tg_o = _per_obs(gt, cam_idx)

    pts = _points(obj_xy)  # (B, O, N, 3)
    p_base = pts @ rb.transpose(-1, -2) + bt[:, None, None, :]
    p_g = (p_base - tbo[:, :, None, :]) @ rbo
    p_c = (p_g - tg_o[:, :, None, :]) @ rg_o

    j_intr, h = pinhole.project_point_jacobians(_per_obs(intr, cam_idx), p_c)  # (B, O, N, 2, pc), (.., 2, 3)
    onehot = (cam_idx[..., None] == torch.arange(c, device=cam_idx.device)).to(x.dtype)  # (B, O, C)
    oh = onehot[:, :, None, None, :, None]

    def blockwise(j):
        return (j[..., None, :] * oh).reshape(j.shape[:-1] + (c * j.shape[-1],))

    # row vectors times 3x3 matrices: one matmul per observation over all
    # its rows, and a [p]_x = a x p, rather than one tiny product per row
    def per_obs(a, m):
        return (a.reshape(a.shape[:2] + (-1, 3)) @ m).reshape(a.shape)

    r_cb = rg_o.transpose(-1, -2) @ rbo.transpose(-1, -2)  # (B, O, 3, 3)
    h_cb = per_obs(h, r_cb)
    pts_rows = pts[..., None, :]
    jac = torch.cat(
        [
            blockwise(j_intr),
            blockwise(torch.linalg.cross(h, p_c[..., None, :], dim=-1)),
            blockwise(-per_obs(h, rg_o.transpose(-1, -2))),
            -torch.linalg.cross(per_obs(h_cb, rb.expand_as(r_cb)), pts_rows, dim=-1),
            h_cb,
        ],
        dim=-1,
    )
    jac = jac * mask[..., None, None]
    return jac.reshape(jac.shape[0], -1, jac.shape[-1])


def _free_and_lower(opts: BundleOptions, pc, c, model=PINHOLE):
    """(ambient free mask, fx/fy lower bounds) of one rig, as numpy."""
    n = c * pc + 7 * c + 7
    free = np.ones((n,), bool)
    o_int, o_gq = 0, c * pc
    o_bq = c * pc + 7 * c
    if not opts.optimize_target_pose:
        free[o_bq:] = False
    if not opts.optimize_hand_eye:
        free[o_gq:o_bq] = False
    if not opts.optimize_intrinsics:
        free[o_int : o_int + c * pc] = False
    elif not opts.optimize_skew:
        free[o_int + np.arange(c) * pc + model.idx_skew] = False
    lower = np.full((n,), -np.inf)
    if opts.optimize_intrinsics:
        lower[o_int + np.arange(c) * pc + model.idx_fx] = 0.0
        lower[o_int + np.arange(c) * pc + model.idx_fy] = 0.0
    return free, lower


def optimize_bundle_device(
    obj_xy,
    img_uv,
    b_se3_g,
    cam_idx,
    init_intrs,
    init_g_se3_c,
    init_b_se3_t,
    mask=None,
    model=PINHOLE,
    opts: BundleOptions | None = None,
    precision: str = "f64",
    analytic_jac: bool = True,
):
    """Refine B rigs on the tensors' device: the reference's parameters, in
    its order, with a leading B axis on every tensor (the reference's takes
    one rig). obj_xy/img_uv: (B, O, N, 2); b_se3_g: (B, O, 4, 4) constant
    gripper poses; cam_idx: (B, O) int; init_intrs: (B, C, pc);
    init_g_se3_c: (B, C, 4, 4); init_b_se3_t: (B, 4, 4); mask: (B, O, N).
    ``model``: any registry model (``MODELS``), a spec or its name;
    ``precision`` "f64" or "mixed" (a float32 LM, at most 30 iterations
    to epsilon max(1e-5, epsilon), then the float64 solve from its result;
    the reference runs plain float64 for "mixed_jac", silently, the port
    refuses it). analytic_jac: the analytic
    pinhole Jacobian (the default), or False for forward-mode autodiff,
    which every other model uses.

    Returns (LMOutput, intr (B, C, pc), g_se3_c (B, C, 4, 4), b_se3_t
    (B, 4, 4), cov (B, n, n), cov_ok (B,)) with n = C*pc + 7C + 7; with
    covariance off, cov is zero and cov_ok False.
    """
    model = check_ported(model, models=MODELS)
    check_precision(precision, ("f64", "mixed"))
    opts = opts or BundleOptions()
    b, o, n = obj_xy.shape[0], obj_xy.shape[1], obj_xy.shape[2]
    c = init_intrs.shape[1]
    pc = model.param_count
    dtype, device = obj_xy.dtype, obj_xy.device
    mask = torch.ones((b, o, n), dtype=dtype, device=device) if mask is None else mask.to(dtype)
    cam_idx = cam_idx.to(torch.long)

    gq, gt = blocks.poses_to_quat_tran(init_g_se3_c)
    bq = se3.rotmat_to_quat(se3.rot(init_b_se3_t))
    x0 = torch.cat([init_intrs.reshape(b, -1), gq.reshape(b, -1), gt.reshape(b, -1), bq, se3.tra(init_b_se3_t)], dim=-1)
    manifold = make_manifold(pc, c)
    free_np, lower_np = _free_and_lower(opts, pc, c, model)
    free = torch.as_tensor(free_np, device=device)
    lower = torch.as_tensor(lower_np, dtype=dtype, device=device)

    block_ids = np.repeat(np.arange(o), 2 * n)
    data = (obj_xy, img_uv, mask, b_se3_g, cam_idx)

    def res_fn(x, *d):
        return _residual(x, *d, pc, c, model)

    def jac_fn(x, *d):
        return _residual_jac_pinhole(x, *d, pc, c)

    jac = jac_fn if analytic_jac and model.name == PINHOLE.name else None
    solve = functools.partial(
        lm.lm_core, res_fn, manifold=manifold, free_mask=free, block_ids=block_ids, num_blocks=o, jac_fn=jac
    )
    if precision == "mixed":
        f32 = torch.float32
        coarse = dataclasses.replace(
            opts.core, epsilon=max(1e-5, opts.core.epsilon), max_iterations=min(30, opts.core.max_iterations)
        )
        data32 = tuple(d.to(f32) if d.is_floating_point() else d for d in data)
        x0 = solve(x0.to(f32), data=data32, options=coarse, lower=lower.to(f32)).x.to(dtype)
    out = solve(x0, data=data, options=opts.core, lower=lower)
    if opts.core.compute_covariance:
        cov, cov_ok = lm.covariance(
            res_fn, out.x, manifold, data=data, free_mask=free, block_ids=block_ids, num_blocks=o,
            huber_delta=opts.core.huber_delta, jac_fn=jac,
        )
    else:
        # callers that disable covariance do not pay the extra linearization
        n_amb = manifold.ambient_dim
        cov = torch.zeros((b, n_amb, n_amb), dtype=dtype, device=device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=device)

    intr, gqf, gtf, bqf, btf = unpack(out.x, pc, c)
    g_se3_c = blocks.quat_tran_to_poses(gqf, gtf)
    b_se3_t = se3.make_se3(se3.quat_to_rotmat(bqf), btf)
    return out, intr, g_se3_c, b_se3_t, cov, cov_ok


@dataclasses.dataclass
class BundleResult:
    core: OptimResult
    cameras: np.ndarray  # (C, pc)
    g_se3_c: np.ndarray  # (C, 4, 4)
    b_se3_t: np.ndarray  # (4, 4)


def bundle_result(lm_out, intr, g_se3_c, b_se3_t, cov, cov_ok, opts: BundleOptions) -> BundleResult:
    """One rig's BundleResult from host (numpy) slices of the device
    tuple."""
    core = OptimResult(
        success=bool(lm_out.success),
        covariance=np.asarray(cov) if (opts.core.compute_covariance and bool(cov_ok)) else None,
        final_cost=float(lm_out.cost),
        iterations=int(lm_out.iterations),
        termination=TerminationType(int(lm_out.termination)),
        initial_cost=float(lm_out.initial_cost),
    )
    core.report = brief_report(core)
    return BundleResult(core=core, cameras=np.asarray(intr), g_se3_c=np.asarray(g_se3_c), b_se3_t=np.asarray(b_se3_t))


def optimize_bundle(
    obj_xy,
    img_uv,
    b_se3_g,
    cam_idx,
    initial_cameras,
    init_g_se3_c,
    init_b_se3_t,
    mask=None,
    model=PINHOLE,
    opts: BundleOptions | None = None,
    analytic_jac: bool = True,
) -> BundleResult:
    """Host-facing wrapper for ONE rig, a B = 1 call of
    ``optimize_bundle_device``. obj_xy/img_uv: (O, N, 2); b_se3_g:
    (O, 4, 4); cam_idx: (O,); initial_cameras: (C, pc); init_g_se3_c:
    (C, 4, 4); init_b_se3_t: (4, 4); mask: (O, N); all tensors on one
    device."""
    opts = opts or BundleOptions()
    if initial_cameras.shape[0] == 0:
        raise ValueError("No camera intrinsics provided")
    if obj_xy.shape[0] == 0:
        raise ValueError("No observations provided")
    out = optimize_bundle_device(
        obj_xy[None], img_uv[None], b_se3_g[None], cam_idx[None], initial_cameras[None], init_g_se3_c[None],
        init_b_se3_t[None], mask=None if mask is None else mask[None], model=model, opts=opts,
        analytic_jac=analytic_jac,
    )
    lm_out = type(out[0])(*(f[0].cpu().numpy() for f in out[0]))
    return bundle_result(lm_out, *(t[0].cpu().numpy() for t in out[1:]), opts)
