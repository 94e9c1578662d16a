"""Joint multi-camera extrinsics (+ optional intrinsics) refinement for any
registry camera model, batched over rigs (port of
``calibration_tpu/optim/extrinsics.py``, Schur and dense solvers).

Parameter layout per rig: [intr_0..intr_C, cam_quat_0.., cam_tran_0..,
view_quat_0.., view_tran_0..], the reference's ExtrinsicBlocks order.
Gauge: camera 0's pose is frozen when the extrinsics are optimized, target
pose 0 when the intrinsics are. One Huber block per (view, camera) pair;
fx, fy get a zero lower bound; skew is frozen unless ``optimize_skew``.

The Schur engine's global block is the C intrinsics plus the C camera
poses (a manifold: the camera quaternions retract by right-multiplied
exp), the per-view block the target pose. For the pinhole model the
Schur Jacobian is the analytic ``_view_residual_jac_pinhole``, which the
reference's tests hold equal to its jacfwd; for any other model it is
forward mode: ``jac_mode="grouped"`` (``_view_residual_jac_grouped``, one
(pc + 12)-tangent sweep per camera, scattered block-diagonally) or "full"
(``lm_schur.view_jacobian_fn`` over the whole global tangent). The dense
solver (``solver="dense"``) runs ``lm_core`` on the whole parameter vector
with forward-mode Jacobians and the dense covariance.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..models import pinhole
from ..models.registry import PINHOLE, SPECS
from ..ops import se3
from . import blocks, lm, lm_graphs, lm_schur
from .core import OptimOptions, OptimResult, TerminationType, brief_report, check_ported
from .manifold import ProductManifold, euclid, quat

# the camera models the extrinsics solvers take (check_ported): every
# registry model
MODELS = tuple(m.name for m in SPECS)


@dataclasses.dataclass(frozen=True)
class ExtrinsicOptions:
    """The reference's ExtrinsicOptions, field for field and in its order."""

    core: OptimOptions = dataclasses.field(default_factory=OptimOptions)
    optimize_intrinsics: bool = True
    optimize_skew: bool = False
    optimize_extrinsics: bool = True


def make_manifold(pc: int, c: int, v: int) -> ProductManifold:
    return ProductManifold(
        [euclid(pc)] * c + [quat()] * c + [euclid(3)] * c + [quat()] * v + [euclid(3)] * v
    )


def global_manifold(pc: int, c: int) -> ProductManifold:
    """The Schur global block: C intrinsics, C camera quaternions, C camera
    translations."""
    return ProductManifold([euclid(pc)] * c + [quat()] * c + [euclid(3)] * c)


def unpack(x, pc, c, v):
    """(..., C*pc + 7C + 7V) -> (intr (..., C, pc), cam quats (..., C, 4),
    cam trans (..., C, 3), view quats (..., V, 4), view trans (..., V, 3))."""
    lead = x.shape[:-1]
    sizes = [c * pc, 4 * c, 3 * c, 4 * v, 3 * v]
    shapes = [(c, pc), (c, 4), (c, 3), (v, 4), (v, 3)]
    return tuple(p.reshape(lead + s) for p, s in zip(torch.split(x, sizes, dim=-1), shapes))


def _split_global(xg, pc, c):
    intr, cq, ct, _, _ = unpack(xg, pc, c, 0)
    return intr, cq, ct


def _rig_points(xg, vq, vt, obj, pc, c):
    """Camera-frame points (B, V, C, N, 3) of planar target points obj
    (B, V, C, N, 2), with what the Jacobian reuses."""
    intr, cq, ct = _split_global(xg, pc, c)
    cam_rot = se3.quat_to_rotmat(cq)[:, None, :, None]  # (B, 1, C, 1, 3, 3)
    view_rot = se3.quat_to_rotmat(vq)[:, :, None, None]  # (B, V, 1, 1, 3, 3)
    # rig-frame points R_v [x, y, 0] + t_v
    p_r = view_rot[..., 0] * obj[..., 0:1] + view_rot[..., 1] * obj[..., 1:2] + vt[:, :, None, None, :]
    pc3 = torch.sum(cam_rot * p_r[..., None, :], dim=-1) + ct[:, None, :, None, :]
    return intr, cam_rot, view_rot, p_r, pc3


def _view_residual(xg, vq, vt, obj, uv, mask, pc, c, model=PINHOLE):
    """Per-view residuals (B, V, C*N*2): each target view seen by all C
    cameras through ``model``, rows ordered (camera, point, u/v). xg:
    (B, C*pc + 7C); vq/vt: (B, V, 4)/(B, V, 3); obj/uv: (B, V, C, N, 2);
    mask (B, V, C, N)."""
    intr, _, _, _, pc3 = _rig_points(xg, vq, vt, obj, pc, c)
    uv_hat = model.project(intr[:, None, :, None, :], pc3)
    r = (uv_hat - uv) * mask[..., None]
    return r.reshape(r.shape[:2] + (-1,))


def _block_diag_cols(j, c):
    """Per-camera columns (..., C, N, 2, k) -> (..., C, N, 2, C*k): camera
    c's rows touch only camera c's columns."""
    eye = torch.eye(c, dtype=j.dtype, device=j.device)
    out = j[..., None, :] * eye[:, None, None, :, None]
    return out.reshape(j.shape[:-1] + (c * j.shape[-1],))


def _view_residual_jac_pinhole(xg, vq, vt, obj, uv, mask, pc, c):
    """Analytic tangent Jacobian of ``_view_residual``: (B, V, C*N*2,
    C*pc + 6C + 6), columns [intr_0..intr_C, omega_cam x C, t_cam x C,
    omega_v (3), t_v (3)], the global manifold's tangent layout followed by
    the per-view pose.

    Chain rule of project(intr_c, R_c (R_v exp(w_v^) p + t_v) + t_c) with
    right-multiplied quaternion retractions on both poses: for a row vector
    a, a (-R [p]_x) = (p x (a R)) row-wise.
    """
    intr, cam_rot, view_rot, p_r, pc3 = _rig_points(xg, vq, vt, obj, pc, c)
    j_intr, h = pinhole.project_point_jacobians(intr[:, None], pc3)  # (B, V, C, N, 2, pc), (.., 2, 3)
    h_rc = h @ cam_rot  # d/d p_r, also d/d t_v
    pts = torch.cat([obj, torch.zeros_like(obj[..., :1])], dim=-1)
    j_wc = torch.linalg.cross(p_r[..., None, :], h_rc, dim=-1)
    j_wv = torch.linalg.cross(pts[..., None, :], h_rc @ view_rot, dim=-1)
    jac = torch.cat(
        [
            _block_diag_cols(j_intr, c),
            _block_diag_cols(j_wc, c),
            _block_diag_cols(h, c),
            j_wv,
            h_rc,
        ],
        dim=-1,
    )
    jac = jac * mask[..., None, None]
    return jac.reshape(jac.shape[:2] + (-1, jac.shape[-1]))


def _view_residual_jac_grouped(xg, vq, vt, obj, uv, mask, pc, c, model=PINHOLE):
    """Forward-mode tangent Jacobian of ``_view_residual`` for any model, in
    ``_view_residual_jac_pinhole``'s layout, grouped per camera.

    Camera c's rows depend only on its own intrinsics and pose and on the
    view's pose, so one sweep per coordinate of the local (pc + 12)-tangent
    [intr_c (pc), omega_c (3), t_c (3), omega_v (3), t_v (3)], every camera
    perturbed in its own copy of the coordinate at once, gives every
    camera's block; the blocks are scattered block-diagonally. The sweeps
    run as one evaluation of the residual on the batch repeated pc + 12
    times, copy k carrying unit tangent k as a dual number (the idiom of
    ``lm_schur.view_jacobian_fn``), through the engine's own retractions.
    The fx/fy lower bounds are taken as inactive, as in the analytic one.
    """
    b, v, _, n = obj.shape[:4]
    k = pc + 12
    g_manifold = global_manifold(pc, c)
    tan = torch.eye(k, dtype=xg.dtype, device=xg.device)[:, None, :].expand(k, b, k).reshape(k * b, k)
    # the global tangent layout [intr x C | omega_cam x C | t_cam x C]
    tan_g = torch.cat([tan[:, :pc].repeat(1, c), tan[:, pc : pc + 3].repeat(1, c), tan[:, pc + 3 : pc + 6].repeat(1, c)],
                      dim=-1)
    tan_v = tan[:, None, pc + 6 :].expand(k * b, v, 6)

    def rep(a):  # (B, ...) -> (k * B, ...), copy j carries column j
        return a.expand((k,) + a.shape).reshape((k * a.shape[0],) + a.shape[1:])

    with lm.dual_level():
        xr = g_manifold.retract(rep(xg), fwAD.make_dual(torch.zeros_like(tan_g), tan_g))
        q_new, t_new = lm_schur._retract_views(rep(vq), rep(vt), fwAD.make_dual(torch.zeros_like(tan_v), tan_v))
        r = _view_residual(xr, q_new, t_new, rep(obj), rep(uv), rep(mask), pc, c, model)
        jac = fwAD.unpack_dual(r).tangent  # (k * B, V, C*N*2)
    jac = jac.reshape(k, b, v, c, n, 2).permute(1, 2, 3, 4, 5, 0)  # (B, V, C, N, 2, k)
    out = torch.cat(
        [
            _block_diag_cols(jac[..., :pc], c),
            _block_diag_cols(jac[..., pc : pc + 3], c),
            _block_diag_cols(jac[..., pc + 3 : pc + 6], c),
            jac[..., pc + 6 :],
        ],
        dim=-1,
    )
    return out.reshape(b, v, -1, out.shape[-1])


def _residual_fns(pc, c, model=PINHOLE, jac_mode="grouped"):
    """(per-view residual, its Schur Jacobian) of ``model``: the analytic
    one for the pinhole model, else the forward-mode ``jac_mode``."""
    res = lambda xg, q, t, o, u, m: _view_residual(xg, q, t, o, u, m, pc, c, model)  # noqa: E731
    if model.name == PINHOLE.name:
        jac = lambda xg, q, t, o, u, m: _view_residual_jac_pinhole(xg, q, t, o, u, m, pc, c)  # noqa: E731
    elif jac_mode == "grouped":  # forward mode: host state, never graphed
        jac = lm_graphs.eager(
            lambda xg, q, t, o, u, m: _view_residual_jac_grouped(xg, q, t, o, u, m, pc, c, model)
        )
    else:
        jac = lm_schur.view_jacobian_fn(res, g_manifold=global_manifold(pc, c))
    return res, jac


def _free_mask(opts: ExtrinsicOptions, pc, c, v, model=PINHOLE):
    """(C*pc + 7C + 7V,) ambient free mask with the reference's gauge."""
    free = np.ones((c * pc + 7 * c + 7 * v,), bool)
    o_int, o_cq, o_ct = 0, c * pc, c * pc + 4 * c
    o_vq, o_vt = c * pc + 7 * c, c * pc + 7 * c + 4 * v
    if not opts.optimize_intrinsics:
        free[o_int : o_int + c * pc] = False
    else:  # gauge: first target pose constant
        free[o_vq : o_vq + 4] = False
        free[o_vt : o_vt + 3] = False
    if not opts.optimize_extrinsics:
        free[o_cq:o_vq] = False
    else:  # gauge: camera 0 pose constant
        free[o_cq : o_cq + 4] = False
        free[o_ct : o_ct + 3] = False
    if not opts.optimize_skew:
        free[o_int + np.arange(c) * pc + model.idx_skew] = False
    return free


def _check_solver(solver: str) -> None:
    if solver not in ("schur", "dense"):
        raise ValueError(f"unknown solver '{solver}'")


def _residual_flat(x, obj_xy, img_uv, mask, model=PINHOLE):
    """The dense solver's residual (B, 2NCV) of the flat parameters, rows
    ordered (view, camera, point, u/v)."""
    v, c = obj_xy.shape[-4], obj_xy.shape[-3]
    pc = (x.shape[-1] - 7 * c - 7 * v) // c
    ga = c * pc + 7 * c
    lead = x.shape[:-1]
    vq = x[..., ga : ga + 4 * v].reshape(lead + (v, 4))
    vt = x[..., ga + 4 * v :].reshape(lead + (v, 3))
    r = _view_residual(x[..., :ga], vq, vt, obj_xy, img_uv, mask, pc, c, model)
    return r.reshape(lead + (-1,))


def _optimize_dense(x0, obj_xy, img_uv, mask, opts, free, lower, manifold, model):
    """``optimize_extrinsics_device`` with solver="dense": (LMOutput, cov,
    cov_ok). Unlike the reference's dense branch, which computes the
    covariance whatever the options say, it is computed only when
    ``compute_covariance`` asks for it, as on the Schur path."""
    b, v, c, n = obj_xy.shape[:4]
    block_ids = np.repeat(np.arange(v * c), 2 * n)
    data = (obj_xy, img_uv, mask)

    def res_fn(x, obj, uv, m):
        return _residual_flat(x, obj, uv, m, model)

    out = lm.lm_core(
        res_fn, x0, manifold, data=data, options=opts.core, free_mask=free, block_ids=block_ids,
        num_blocks=v * c, lower=lower,
    )
    if opts.core.compute_covariance:
        cov, cov_ok = lm.covariance(
            res_fn, out.x, manifold, data=data, free_mask=free, block_ids=block_ids, num_blocks=v * c,
            huber_delta=opts.core.huber_delta,
        )
    else:
        cov = torch.zeros((b, x0.shape[-1], x0.shape[-1]), dtype=x0.dtype, device=x0.device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=x0.device)
    return out, cov, cov_ok


def optimize_extrinsics_device(
    obj_xy, img_uv, init_intrs, init_c_se3_r, init_r_se3_t, mask=None, model=PINHOLE, opts=None,
    solver="schur", analytic_jac=False, jac_mode="grouped",
):
    """Refine B rigs on the tensors' device: the reference's parameters, in
    its order, with a leading B axis on every tensor (the reference's takes
    one rig). obj_xy/img_uv: (B, V, C, N, 2); init_intrs: (B, C, pc);
    init_c_se3_r: (B, C, 4, 4); init_r_se3_t: (B, V, 4, 4); mask:
    (B, V, C, N). ``model``: any registry model (``MODELS``), a spec or
    its name. For the pinhole model the Schur Jacobian is the analytic
    one, which equals each of the reference's to 1e-10, so any
    ``analytic_jac`` and ``jac_mode`` is accepted; for another model
    ``jac_mode`` ("grouped" or "full") chooses the forward-mode Jacobian,
    as in the reference.

    Returns (LMOutput, intr (B, C, pc), c_se3_r (B, C, 4, 4), r_se3_t
    (B, V, 4, 4), cov (B, n, n), cov_ok (B,)) with n = C*pc + 7C + 7V.
    """
    model = check_ported(model, models=MODELS)
    _check_solver(solver)
    if jac_mode not in ("grouped", "full"):
        raise NotImplementedError(f"jac_mode '{jac_mode}' is not ported yet (grouped|full)")
    opts = opts or ExtrinsicOptions()
    b, v, c = obj_xy.shape[0], obj_xy.shape[1], obj_xy.shape[2]
    pc = model.param_count
    dtype, device = obj_xy.dtype, obj_xy.device
    mask = torch.ones(obj_xy.shape[:-1], dtype=dtype, device=device) if mask is None else mask.to(dtype)

    cq, ct = blocks.poses_to_quat_tran(init_c_se3_r)
    vq, vt = blocks.poses_to_quat_tran(init_r_se3_t)
    xg0 = torch.cat([init_intrs.reshape(b, -1), cq.reshape(b, -1), ct.reshape(b, -1)], dim=-1)
    ga = xg0.shape[-1]
    manifold = make_manifold(pc, c, v)
    g_manifold = global_manifold(pc, c)

    free_np = _free_mask(opts, pc, c, v, model)
    free = torch.as_tensor(free_np, device=device)
    lower = np.full((ga,), -np.inf)
    lower[np.arange(c) * pc + model.idx_fx] = 0.0
    lower[np.arange(c) * pc + model.idx_fy] = 0.0
    # per-view pose freezing is the target-0 gauge
    view_free = torch.as_tensor(free_np[ga : ga + 4 * v].reshape(v, 4)[:, 0], dtype=dtype, device=device)

    if solver == "dense":
        lower_a = torch.cat([torch.as_tensor(lower, dtype=dtype, device=device),
                             torch.full((7 * v,), -torch.inf, dtype=dtype, device=device)])
        x0 = torch.cat([xg0, vq.reshape(b, -1), vt.reshape(b, -1)], dim=-1)
        out, cov, cov_ok = _optimize_dense(x0, obj_xy, img_uv, mask, opts, free, lower_a, manifold, model)
        intr, cqf, ctf, vqf, vtf = unpack(out.x, pc, c, v)
        return (out, intr, blocks.quat_tran_to_poses(cqf, ctf), blocks.quat_tran_to_poses(vqf, vtf), cov,
                cov_ok)

    res_fn, jac_fn = _residual_fns(pc, c, model, jac_mode)
    view_data = (obj_xy, img_uv, mask)
    sout = lm_schur.lm_core_schur(
        res_fn, jac_fn, xg0, vq, vt, view_data, options=opts.core, g_free=free[:ga],
        view_valid=view_free.expand(b, v),
        lower_g=torch.as_tensor(lower, dtype=dtype, device=device), g_manifold=g_manifold, blocks_per_view=c,
    )
    out = sout.as_lm_output(blocks.pack_intr_quats_trans)
    n_amb = manifold.ambient_dim
    if opts.core.compute_covariance:
        c_t, _ = lm_schur.tangent_covariance(
            res_fn, jac_fn, sout.xg, sout.quats, sout.trans, view_data, g_manifold=g_manifold,
            tan_free=manifold.ambient_to_tangent_mask(free).to(dtype),
            huber_delta=opts.core.huber_delta, blocks_per_view=c,
        )
        cov, cov_ok = lm.covariance_from_tangent(c_t, out.x, manifold)
    else:
        cov = torch.zeros((b, n_amb, n_amb), dtype=dtype, device=device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=device)

    intr, cqf, ctf = _split_global(sout.xg, pc, c)
    c_se3_r = blocks.quat_tran_to_poses(cqf, ctf)
    r_se3_t = blocks.quat_tran_to_poses(sout.quats, sout.trans)
    return out, intr, c_se3_r, r_se3_t, cov, cov_ok


@dataclasses.dataclass
class ExtrinsicOptimizationResult:
    core: OptimResult
    cameras: np.ndarray  # (C, pc)
    c_se3_r: np.ndarray  # (C, 4, 4)
    r_se3_t: np.ndarray  # (V, 4, 4)


def optimize_extrinsics(
    obj_xy, img_uv, init_cameras, init_c_se3_r, init_r_se3_t, mask=None, model=PINHOLE, opts=None,
    solver="schur", analytic_jac=False,
) -> ExtrinsicOptimizationResult:
    """Host-facing wrapper for ONE rig, a B = 1 call of
    ``optimize_extrinsics_device``. obj_xy/img_uv: (V, C, N, 2);
    init_cameras: (C, pc); init_c_se3_r: (C, 4, 4); init_r_se3_t:
    (V, 4, 4); mask: (V, C, N); all tensors on one device."""
    opts = opts or ExtrinsicOptions()
    if init_cameras.shape[0] != init_c_se3_r.shape[0]:
        raise ValueError("Incompatible pose vector sizes for joint optimization")
    out, intr, c_se3_r, r_se3_t, cov, cov_ok = optimize_extrinsics_device(
        obj_xy[None], img_uv[None], init_cameras[None], init_c_se3_r[None], init_r_se3_t[None],
        mask=None if mask is None else mask[None], model=model, opts=opts, solver=solver,
        analytic_jac=analytic_jac,
    )
    core = OptimResult(
        success=bool(out.success[0]),
        covariance=(
            cov[0].cpu().numpy() if (opts.core.compute_covariance and bool(cov_ok[0])) else None
        ),
        final_cost=float(out.cost[0]),
        iterations=int(out.iterations[0]),
        termination=TerminationType(int(out.termination[0])),
        initial_cost=float(out.initial_cost[0]),
    )
    core.report = brief_report(core)
    return ExtrinsicOptimizationResult(
        core=core,
        cameras=intr[0].cpu().numpy(),
        c_se3_r=c_se3_r[0].cpu().numpy(),
        r_se3_t=r_se3_t[0].cpu().numpy(),
    )
