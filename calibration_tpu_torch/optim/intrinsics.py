"""Joint intrinsics + per-view pose refinement, generic over the camera
model and batched over cameras (port of
``calibration_tpu/optim/intrinsics.py``: ``optimize_intrinsics_device``
with the Schur or the dense solver, at float64 or a mixed precision,
``intrinsics_covariance_device``, and the host wrapper
``optimize_intrinsics``).

Parameter layout per camera: [intr(pc), quat_0..quat_V, t_0..t_V], the
reference's IntrinsicBlocks order. One Huber block per view. fx, fy get a
zero lower bound; skew is frozen unless ``optimize_skew``. The Schur
solver's Jacobian is the analytic ``_view_residual_jac_pinhole`` for the
pinhole model (``ANALYTIC_VIEW_JACOBIANS``; the reference's tests hold it
equal to its jacfwd) and the
forward-mode ``lm_schur.view_jacobian_fn`` for every other model, as the
reference runs jacfwd for them; the dense solver (``lm_core``)
differentiates the whole residual by forward-mode autodiff.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..models.camera_matrix import CalibrationBounds
from ..models.registry import PINHOLE, SCHEIMPFLUG
from ..ops import se3
from . import blocks, lm, lm_graphs, lm_schur
from .core import OptimOptions, OptimResult, TerminationType, brief_report, check_ported, check_precision
from .manifold import ProductManifold, euclid, quat


@dataclasses.dataclass(frozen=True)
class IntrinsicsOptimOptions:
    """The reference's IntrinsicsOptimOptions, field for field and in its
    order, so JSON configs and reports (which write positional ``field_N``
    keys) match. ``bounds`` is carried, not read, as in the reference;
    ``mixed_coarse_epsilon`` is the float32 phase's tolerance under the
    mixed precisions."""

    core: OptimOptions = dataclasses.field(default_factory=OptimOptions)
    num_radial: int = 2
    optimize_skew: bool = False
    bounds: CalibrationBounds | None = None
    fixed_distortion_indices: tuple = ()
    fixed_distortion_values: tuple = ()
    mixed_coarse_epsilon: float = 1e-4


def make_manifold(pc: int, num_views: int) -> ProductManifold:
    return ProductManifold([euclid(pc)] + [quat()] * num_views + [euclid(3)] * num_views)


# the camera models the intrinsics solvers take (check_ported)
MODELS = (PINHOLE.name, SCHEIMPFLUG.name)
# the precisions each solver takes (check_precision): "mixed" runs a
# float32 LM (at most 30 iterations, epsilon at least mixed_coarse_epsilon),
# then the float64 solve from its result; "mixed_jac", Schur only, runs
# that first phase in float64 with the Jacobian and its grams in float32.
# (The reference's dense solve runs plain float64 for "mixed_jac", silently.)
PRECISIONS = {"schur": ("f64", "mixed", "mixed_jac"), "dense": ("f64", "mixed")}


def reproject_residuals(intr, quats, trans, obj_xy, img_uv, mask, model=PINHOLE):
    """(B, V, N, 2) masked pixel residuals. intr (B, pc); quats (B, V, 4);
    trans (B, V, 3); obj_xy/img_uv (B, V, N, 2); mask (B, V, N)."""
    rot = se3.quat_to_rotmat(quats)  # (B, V, 3, 3)
    pts = torch.cat([obj_xy, torch.zeros_like(obj_xy[..., :1])], dim=-1)
    pc3 = pts @ rot.transpose(-1, -2) + trans[..., None, :]
    uv_hat = model.project(intr[:, None, None, :], pc3)
    return (uv_hat - img_uv) * mask[..., None]


def _unpack(x, pc, v):
    """(B, pc + 7V) -> (intr (B, pc), quats (B, V, 4), trans (B, V, 3))."""
    lead = x.shape[:-1]
    return x[..., :pc], x[..., pc : pc + 4 * v].reshape(lead + (v, 4)), x[..., pc + 4 * v :].reshape(lead + (v, 3))


def _residual_flat(x, obj_xy, img_uv, mask, model=PINHOLE):
    """The dense solver's residual (B, 2NV) of the flat parameters."""
    v = obj_xy.shape[-3]
    r = reproject_residuals(*_unpack(x, x.shape[-1] - 7 * v, v), obj_xy, img_uv, mask, model)
    return r.reshape(r.shape[:-3] + (-1,))


def _view_residual(intr, quats, trans, obj_xy, img_uv, mask, model=PINHOLE):
    """Per-view flattened residuals (B, V, 2N), rows interleaved (u, v)."""
    r = reproject_residuals(intr, quats, trans, obj_xy, img_uv, mask, model)
    return r.reshape(r.shape[:-2] + (-1,))


def _view_functions(model):
    """(residual_fn, jac_fn) of the Schur engine for ``model``: its analytic
    Jacobian where ``ANALYTIC_VIEW_JACOBIANS`` holds one, forward-mode
    autodiff for any other model."""
    res = functools.partial(_view_residual, model=model)
    return res, ANALYTIC_VIEW_JACOBIANS.get(model.name) or lm_schur.view_jacobian_fn(res)


def schur_graphed(model, device) -> bool:
    """Whether the Schur solves of ``model`` on ``device`` replay CUDA
    graphs (``optim/lm_graphs``): on CUDA, with a Jacobian that a graph
    key follows (forward mode is never graphed)."""
    return torch.device(device).type == "cuda" and lm_graphs.key(_view_functions(model), ()) is not None


def _skew_z0(pts):
    """[p]_x for planar target points p = (px, py, 0): (..., 3, 3)."""
    px, py = pts[..., 0], pts[..., 1]
    z = torch.zeros_like(px)
    return torch.stack(
        [
            torch.stack([z, z, py], -1),
            torch.stack([z, z, -px], -1),
            torch.stack([-py, px, z], -1),
        ],
        dim=-2,
    )


def _view_residual_jac_pinhole(intr, quats, trans, obj_xy, img_uv, mask):
    """Analytic tangent Jacobian of ``_view_residual``: (B, V, 2N, 16),
    columns [fx, fy, cx, cy, skew, k1, k2, k3, p1, p2, omega(3), dt(3)].

    Rotation convention: right-multiplied quaternion retraction
    q (x) exp_quat(omega) == R exp(omega^), so d p_c / d omega = -R [p]_x.
    """
    from ..models import pinhole

    rot = se3.quat_to_rotmat(quats)
    pts = torch.cat([obj_xy, torch.zeros_like(obj_xy[..., :1])], dim=-1)
    pc = pts @ rot.transpose(-1, -2) + trans[..., None, :]  # (B, V, N, 3)
    j_intr, h = pinhole.project_point_jacobians(intr[:, None, :], pc)
    j_rot = h @ (-rot[..., None, :, :] @ _skew_z0(pts))  # (B, V, N, 2, 3)
    jac = torch.cat([j_intr, j_rot, h], dim=-1) * mask[..., None, None]
    return jac.reshape(jac.shape[:-3] + (-1, jac.shape[-1]))


# the models with an analytic per-view Jacobian, by name (``_view_functions``)
ANALYTIC_VIEW_JACOBIANS = {PINHOLE.name: _view_residual_jac_pinhole}


def _fixed_slot_list(opts: IntrinsicsOptimOptions):
    """Packed distortion slots for opts.fixed_distortion_indices (indices
    address [k1..k_nr, p1, p2]; validated)."""
    nr = opts.num_radial
    slots = []
    for idx in opts.fixed_distortion_indices:
        if idx < 0 or idx >= nr + 2:
            raise ValueError("Fixed distortion index out of range")
        slots.append(idx if idx < nr else 3 + (idx - nr))
    return slots


def _free_mask(model, opts, fixed_slots, pc, b, v, view_valid, device):
    """(B, pc + 7V) ambient free mask: skew frozen unless optimize_skew,
    fixed distortion slots frozen, invalid views' pose blocks frozen."""
    free = np.ones((pc + 7 * v,), bool)
    if not opts.optimize_skew:
        free[model.idx_skew] = False
    for slot in fixed_slots:
        free[model.idx_dist0 + slot] = False
    free = torch.as_tensor(free, device=device).expand(b, pc + 7 * v)
    if view_valid is not None:
        vv = view_valid.bool()
        pose_free = torch.cat([vv.repeat_interleave(4, dim=-1), vv.repeat_interleave(3, dim=-1)], dim=-1)
        free = free & torch.cat([torch.ones((b, pc), dtype=torch.bool, device=device), pose_free], dim=-1)
    return free


def _prepare_mask(obj_xy, mask, view_valid):
    if mask is None:
        mask = torch.ones(obj_xy.shape[:-1], dtype=obj_xy.dtype, device=obj_xy.device)
    mask = mask.to(obj_xy.dtype)
    if view_valid is not None:
        mask = mask * view_valid.to(mask.dtype)[..., None]
    return mask


def intrinsics_covariance_device(obj_xy, img_uv, intr, poses, mask=None, model=PINHOLE, opts=None, view_valid=None):
    """Ambient covariance at a GIVEN solution by the Schur block inverse, so
    a phased solve can defer covariance to one final pass. Every tensor has
    a leading B axis (the reference's takes one camera).
    Returns (cov (B, pc+7V, pc+7V), cov_ok (B,))."""
    model = check_ported(model, models=MODELS)
    opts = opts or IntrinsicsOptimOptions()
    b, v = obj_xy.shape[0], obj_xy.shape[1]
    pc = model.param_count
    mask = _prepare_mask(obj_xy, mask, view_valid)
    manifold = make_manifold(pc, v)
    free = _free_mask(model, opts, _fixed_slot_list(opts), pc, b, v, view_valid, obj_xy.device)
    quats, trans = blocks.poses_to_quat_tran(poses)
    x = blocks.pack_intr_quats_trans(intr, quats, trans)
    c_t, _ = lm_schur.tangent_covariance(
        *_view_functions(model), intr, quats, trans,
        (obj_xy, img_uv, mask),
        tan_free=manifold.ambient_to_tangent_mask(free).to(x.dtype),
        huber_delta=opts.core.huber_delta,
    )
    return lm.covariance_from_tangent(c_t, x, manifold)


def optimize_intrinsics_device(
    obj_xy, img_uv, init_intr, init_poses, mask=None, model=PINHOLE, opts=None, precision="f64",
    view_valid=None, solver="schur", analytic_jac=False,
):
    """Refine B cameras: the reference's parameters, in its order, with a
    leading B axis on every tensor (the reference's takes one camera).
    obj_xy/img_uv: (B, V, N, 2); init_intr: (B, pc); init_poses:
    (B, V, 4, 4); mask: (B, V, N); view_valid: optional (B, V) (invalid
    views get zero residuals and frozen pose blocks). ``model`` is a
    registry model or its name, pinhole or Scheimpflug (``check_ported``);
    ``precision`` one of ``PRECISIONS[solver]``. ``analytic_jac`` is
    accepted for any value:
    pinhole's analytic Jacobian equals the reference's jacfwd to 1e-10, and
    every other model is differentiated by forward-mode autodiff, as in the
    reference.

    solver: "schur" (default) eliminates the per-view pose blocks
    (``lm_core_schur``, block-inverse covariance); "dense" runs the generic
    ``lm_core`` on the whole parameter vector with forward-mode Jacobians
    and the dense covariance: the same damped iteration, more work.

    Returns (LMOutput, intr (B, pc), poses (B, V, 4, 4), view_errors (B, V),
    cov (B, pc+7V, pc+7V), cov_ok (B,)).
    """
    model = check_ported(model, models=MODELS)
    if solver not in PRECISIONS:
        raise ValueError(f"unknown solver '{solver}'")
    check_precision(precision, PRECISIONS[solver])
    opts = opts or IntrinsicsOptimOptions()
    b, v = obj_xy.shape[0], obj_xy.shape[1]
    pc = model.param_count
    dtype, device = obj_xy.dtype, obj_xy.device
    mask = _prepare_mask(obj_xy, mask, view_valid)

    # pin the requested Brown-Conrady coefficients (default 0)
    fixed_slots = _fixed_slot_list(opts)
    init_intr = init_intr.clone()
    for i, slot in enumerate(fixed_slots):
        vals = opts.fixed_distortion_values
        init_intr[:, model.idx_dist0 + slot] = vals[i] if i < len(vals) else 0.0
    quats, trans = blocks.poses_to_quat_tran(init_poses)
    manifold = make_manifold(pc, v)
    free = _free_mask(model, opts, fixed_slots, pc, b, v, view_valid, device)
    lower_g = torch.full((pc,), -torch.inf, dtype=dtype, device=device)
    lower_g[model.idx_fx] = 0.0
    lower_g[model.idx_fy] = 0.0
    if solver == "dense":
        return _optimize_dense(
            obj_xy, img_uv, init_intr, quats, trans, mask, opts, free, lower_g, manifold, model, precision
        )

    view_data = (obj_xy, img_uv, mask)
    view_fns = _view_functions(model)
    schur = functools.partial(
        lm_schur.lm_core_schur, *view_fns, g_free=free[:, :pc], view_valid=view_valid, lower_g=lower_g
    )
    if precision == "mixed_jac":
        s32 = schur(init_intr, quats, trans, view_data, options=_coarse(opts), jac_dtype=torch.float32)
        init_intr, quats, trans = s32.xg, s32.quats, s32.trans
    elif precision == "mixed":
        s32 = schur(*_f32(init_intr, quats, trans), _f32(*view_data), options=_coarse(opts))
        init_intr, quats, trans = (t.to(dtype) for t in (s32.xg, s32.quats, s32.trans))
    sout = schur(init_intr, quats, trans, view_data, options=opts.core)
    out = sout.as_lm_output(blocks.pack_intr_quats_trans)
    n_amb = pc + 7 * v
    if opts.core.compute_covariance:
        c_t, _ = lm_schur.tangent_covariance(
            *view_fns, sout.xg, sout.quats, sout.trans,
            view_data, tan_free=manifold.ambient_to_tangent_mask(free).to(dtype),
            huber_delta=opts.core.huber_delta,
        )
        cov, cov_ok = lm.covariance_from_tangent(c_t, out.x, manifold)
    else:
        cov = torch.zeros((b, n_amb, n_amb), dtype=dtype, device=device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=device)

    poses = blocks.quat_tran_to_poses(sout.quats, sout.trans)
    view_errors = _view_errors(sout.xg, sout.quats, sout.trans, obj_xy, img_uv, mask, model)
    return out, sout.xg, poses, view_errors, cov, cov_ok


def _coarse(opts: IntrinsicsOptimOptions) -> OptimOptions:
    """The float32 phase's options under a mixed precision."""
    return dataclasses.replace(
        opts.core, epsilon=max(opts.mixed_coarse_epsilon, opts.core.epsilon),
        max_iterations=min(30, opts.core.max_iterations),
    )


def _f32(*tensors) -> tuple:
    return tuple(t.to(torch.float32) for t in tensors)


def _view_errors(intr, quats, trans, obj_xy, img_uv, mask, model):
    r = reproject_residuals(intr, quats, trans, obj_xy, img_uv, mask, model)
    cnt = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return torch.sqrt(torch.sum(r * r, dim=(-2, -1)) / (2.0 * cnt))


def _optimize_dense(obj_xy, img_uv, init_intr, quats, trans, mask, opts, free, lower_g, manifold, model, precision):
    """``optimize_intrinsics_device`` with solver="dense"."""
    b, v, n = obj_xy.shape[:3]
    pc = init_intr.shape[-1]
    lower = torch.cat([lower_g, torch.full((7 * v,), -torch.inf, dtype=lower_g.dtype, device=lower_g.device)])
    block_ids = np.repeat(np.arange(v), 2 * n)
    data = (obj_xy, img_uv, mask)
    res = functools.partial(_residual_flat, model=model)
    dense = functools.partial(lm.lm_core, res, manifold=manifold, free_mask=free, block_ids=block_ids, num_blocks=v)
    x0 = blocks.pack_intr_quats_trans(init_intr, quats, trans)
    if precision == "mixed":
        x0 = dense(*_f32(x0), data=_f32(*data), options=_coarse(opts), lower=lower.to(torch.float32)).x.to(x0.dtype)
    out = dense(x0, data=data, options=opts.core, lower=lower)
    if opts.core.compute_covariance:
        cov, cov_ok = lm.covariance(
            res, out.x, manifold, data=data, free_mask=free, block_ids=block_ids, num_blocks=v,
            huber_delta=opts.core.huber_delta,
        )
    else:
        n_amb = pc + 7 * v
        cov = torch.zeros((b, n_amb, n_amb), dtype=obj_xy.dtype, device=obj_xy.device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=obj_xy.device)
    intr, quats_f, trans_f = _unpack(out.x, pc, v)
    poses = blocks.quat_tran_to_poses(quats_f, trans_f)
    return out, intr, poses, _view_errors(intr, quats_f, trans_f, obj_xy, img_uv, mask, model), cov, cov_ok


@dataclasses.dataclass
class IntrinsicsOptimizationResult:
    core: OptimResult
    camera: np.ndarray  # flat intrinsics (model packing)
    c_se3_t: np.ndarray  # (V, 4, 4)
    view_errors: np.ndarray


def optimize_intrinsics(
    obj_xy, img_uv, init_intr, init_c_se3_t, mask=None, model=PINHOLE, opts=None, precision="f64",
    view_valid=None, solver="schur", analytic_jac=False,
) -> IntrinsicsOptimizationResult:
    """Host-facing wrapper for ONE camera, a B = 1 call of
    ``optimize_intrinsics_device``. obj_xy/img_uv: (V, N, 2); init_intr:
    (pc,); init_c_se3_t: (V, 4, 4); mask: (V, N); view_valid: (V,); all
    tensors on one device. Requires >= 4 views."""
    opts = opts or IntrinsicsOptimOptions()
    if obj_xy.shape[0] < 4:
        raise ValueError("Insufficient views for calibration (at least 4 required).")
    out, intr, poses, view_errors, cov, cov_ok = optimize_intrinsics_device(
        obj_xy[None], img_uv[None], init_intr[None], init_c_se3_t[None],
        mask=None if mask is None else mask[None], model=model, opts=opts, precision=precision,
        view_valid=None if view_valid is None else view_valid[None], solver=solver, analytic_jac=analytic_jac,
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
    return IntrinsicsOptimizationResult(
        core=core,
        camera=intr[0].cpu().numpy(),
        c_se3_t=poses[0].cpu().numpy(),
        view_errors=view_errors[0].cpu().numpy(),
    )
