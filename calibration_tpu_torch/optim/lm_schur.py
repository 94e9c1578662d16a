"""Separable (Schur-complement) Levenberg-Marquardt for camera problems,
batched over problems (port of ``calibration_tpu/optim/lm_schur.py``).

Each view's residuals depend only on the shared global block (intrinsics)
and that view's 6-dof pose, so the damped, Jacobi-scaled normal equations
are solved by exact block elimination: batched 6x6 Cholesky inverses and
one pg x pg Schur solve per problem.

Same semantics as the reference: Huber IRLS over ``blocks_per_view`` loss
blocks per view (one per view for a camera, one per (view, camera) pair for
a rig), Nielsen mu-updates, ftol/gtol/xtol = OptimOptions.epsilon, lower
bounds on the ambient global block by projection, a Euclidean or
manifold-valued global block (``g_manifold``: a rig's intrinsics and camera
quaternion poses), frozen coordinates through free masks, and the
linearization cached across rejected trials (one Jacobian per accepted
step; a rejected trial re-solves the cached system with a larger mu).

The reference vmaps a ``lax.while_loop`` over problems, which freezes every
lane whose loop condition is false. Here the loops are Python loops over
the whole batch with per-lane masks: a lane that is done keeps every field,
its ``it`` and ``lin`` counters included, and inner trials advance only the
lanes still active in the outer loop. The host reads one flag per trial to
decide whether any lane is still active.

Its control is the dense engine's (``lm``: the Huber block weights, the
Jacobi scaling, the Nielsen trial update, the host's loop); this module
holds the block normal equations, the Schur solve and the pose retraction.
The device work falls in three segments of fixed shapes, as in
``lm.make_lm_step``: the initial cost, a linearization, a trial. With an
analytic ``jac_fn`` on CUDA and a key for the solve (``lm_graphs``, prefix
``schur``), each is a CUDA graph from the key's second solve on; the
host's flag reads between them stay.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops import linalg, se3
from ..utils import profiling
from . import lm_graphs
from .core import OptimOptions
from .lm import (LMOutput, _first_state, _first_trial, _huber_blocks, _jacobi, _lm_run, _lm_step, _nielsen,
                 _sel, dual_level)


# the trial's cache, the first outputs of a linearization (xg ... outer)
_CACHE_LEN = 18


class SchurOutput(NamedTuple):
    xg: torch.Tensor  # (B, pg)
    quats: torch.Tensor  # (B, V, 4)
    trans: torch.Tensor  # (B, V, 3)
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor  # trials (see LMOutput)
    termination: torch.Tensor
    success: torch.Tensor
    linearizations: torch.Tensor

    def as_lm_output(self, pack) -> LMOutput:
        return LMOutput(
            x=pack(self.xg, self.quats, self.trans),
            cost=self.cost,
            initial_cost=self.initial_cost,
            iterations=self.iterations,
            termination=self.termination,
            success=self.success,
            linearizations=self.linearizations,
        )


def _retract_views(quats, trans, dv):
    """Right-multiply quaternion exp + additive translation."""
    qn = se3.quat_mul(quats, se3.exp_quat(dv[..., :3]))
    qn = qn / torch.linalg.norm(qn, dim=-1, keepdim=True)
    return qn, trans + dv[..., 3:]


def view_jacobian_fn(residual_fn: Callable, *, g_manifold=None) -> Callable:
    """A ``jac_fn`` for ``lm_core_schur`` and ``tangent_covariance`` from any
    per-view residual, by forward-mode autodiff: the Jacobian of the
    retracted residual at zero tangent, columns [global tangent (pg) |
    omega (3) | t (3)], as the reference's ``vmap(jacfwd)`` of its
    ``res_local``. The global block retracts through ``g_manifold`` (a
    rig's camera quaternions), or by addition when it is None. It keeps
    host state (a dual level and its lock), so it is marked
    ``lm_graphs.eager``: its solves are never graphed.

    Each view's residual depends only on its lane's global block and its
    own pose, so one forward sweep per tangent column over the whole
    (B, V) batch gives every view's column at once, and the pg + 6 sweeps
    run as ONE evaluation of ``residual_fn`` on the batch repeated pg + 6
    times, copy c carrying unit tangent c as a dual number. The port's
    other idiom, ``torch.func.vmap`` over (B, V) of ``jacfwd`` (as in
    ``lm.tangent_jacobian``), computes the same to the last bit and spends
    more host time in its batching rules: on an H100 80GB HBM3 at 700 W,
    rows 2S / 2T took 1.30 / 0.86 s with this builder against 1.87 / 1.47
    s (medians of 7 interleaved warm calls, ``tools/profile_torch_cells.py
    --sweeps jacobian``). The global block's lower bounds are taken as
    inactive, as in the analytic Jacobians.
    """

    def jac_fn(xg, quats, trans, *view_data):
        b, v = quats.shape[:2]
        pg = _global_tangent_dim(xg, g_manifold)
        cols = pg + 6
        eye = torch.eye(cols, dtype=xg.dtype, device=xg.device)

        def rep(a):  # (B, ...) -> (cols * B, ...), copy c carries column c
            return a.expand((cols,) + a.shape).reshape((cols * a.shape[0],) + a.shape[1:])

        with dual_level():
            dg = fwAD.make_dual(xg.new_zeros((cols * b, pg)), eye[:, None, :pg].expand(cols, b, pg).reshape(cols * b, pg))
            dv = fwAD.make_dual(xg.new_zeros((cols * b, v, 6)),
                                eye[:, None, None, pg:].expand(cols, b, v, 6).reshape(cols * b, v, 6))
            q_new, t_new = _retract_views(rep(quats), rep(trans), dv)
            xg_new = rep(xg) + dg if g_manifold is None else g_manifold.retract(rep(xg), dg)
            r = residual_fn(xg_new, q_new, t_new, *(rep(d) for d in view_data))
            jac = fwAD.unpack_dual(r).tangent  # (cols * B, V, m)
        return jac.reshape((cols, b) + jac.shape[1:]).permute(1, 2, 3, 0)  # (B, V, m, pg + 6)

    return lm_graphs.eager(jac_fn)


def full_jacobian(residual_view_fn, xg, quats, trans, view_data, g_manifold=None, jac_view_fn=None):
    """The full tangent-space (r, J) of a batch at a solution, assembled
    from the per-view (pg + 6)-tangent blocks in the ProductManifold layout
    [global | quat x V | euclid(3) x V] of ``optimize_intrinsics_device``
    and ``optimize_extrinsics_device``: r (B, V m), J (B, V m, pg + 6V).
    The blocks come from ``jac_view_fn`` (an analytic per-view Jacobian) or
    by forward mode (``view_jacobian_fn``). Feeds ``lm.covariance``'s
    ``jac_r``."""
    jac_fn = jac_view_fn or view_jacobian_fn(residual_view_fn, g_manifold=g_manifold)
    r = residual_view_fn(xg, quats, trans, *view_data)  # (B, V, m)
    jac = jac_fn(xg, quats, trans, *view_data)  # (B, V, m, pg + 6)
    b, v, m = r.shape
    pg = jac.shape[-1] - 6
    # view i's rotation and translation columns go to its own slots
    eye = torch.eye(v, dtype=jac.dtype, device=jac.device)[:, None, :, None]  # (V, 1, V, 1)
    rot = (jac[..., None, pg : pg + 3] * eye).reshape(b, v, m, 3 * v)
    tra = (jac[..., None, pg + 3 :] * eye).reshape(b, v, m, 3 * v)
    jfull = torch.cat([jac[..., :pg], rot, tra], dim=-1)
    return r.reshape(b, v * m), jfull.reshape(b, v * m, pg + 6 * v)


def _huber(r, huber, blocks_per_view=1):
    """Huber IRLS row weights (B, V, m) and robust cost (B,) for r
    (B, V, m). Loss blocks are ``blocks_per_view`` equal runs of each
    view's m residuals."""
    b, v, m = r.shape
    run = m // blocks_per_view
    s = torch.sum((r * r).reshape(b, v * blocks_per_view, run), dim=-1)  # (B, V * blocks)
    if huber <= 0:
        return torch.ones_like(r), 0.5 * torch.sum(s, dim=-1)
    w, cost = _huber_blocks(s, huber)
    return w[..., None].expand(b, v * blocks_per_view, run).reshape(r.shape), cost


def _global_tangent_dim(xg, g_manifold):
    return xg.shape[-1] if g_manifold is None else g_manifold.tangent_dim


@profiling.traced("schur.covariance")
def tangent_covariance(
    residual_fn: Callable,
    jac_fn: Callable,
    xg,
    quats,
    trans,
    view_data,
    *,
    g_manifold=None,
    tan_free=None,
    huber_delta: float = 0.0,
    blocks_per_view: int = 1,
):
    """Tangent-space covariance (J^T J)^-1 at a solution by exact block
    inversion of the separable structure, for a batch of problems.

    With U the global gram, W_v the cross blocks, V_v the view grams and
    S = U - sum_v W_v V_v^-1 W_v^T:
      C_gg = S^-1,  C_gv = -S^-1 W_v V_v^-1,
      C_vivj = delta_ij V_i^-1 + V_i^-1 W_i^T S^-1 W_j V_j^-1.

    Huber rows are re-weighted by sqrt(rho') per loss block
    (``blocks_per_view`` per view). pg is the global block's tangent
    dimension (``g_manifold.tangent_dim`` when given). ``tan_free`` is the
    (B, pg + 6V) tangent free-mask in the manifold layout
    [pg | 3V rot | 3V tra]; frozen dims get a unit diagonal before inversion
    and zeroed rows/cols after. Returns (c_t (B, pg+6V, pg+6V), ok (B,)).
    """
    b = xg.shape[0]
    pg = _global_tangent_dim(xg, g_manifold)
    v = quats.shape[-2]
    dtype, device = xg.dtype, xg.device
    r = residual_fn(xg, quats, trans, *view_data)  # (B, V, m)
    jac = jac_fn(xg, quats, trans, *view_data)  # (B, V, m, pg + 6)
    if huber_delta > 0:
        w, _ = _huber(r, huber_delta, blocks_per_view)
        jac = jac * torch.sqrt(w)[..., None]

    if tan_free is not None:
        tan_free = tan_free.to(dtype).expand(b, pg + 6 * v)
        gmask = tan_free[:, :pg]
        vmask6 = torch.cat(
            [tan_free[:, pg : pg + 3 * v].reshape(b, v, 3), tan_free[:, pg + 3 * v :].reshape(b, v, 3)],
            dim=-1,
        )
    else:
        gmask = torch.ones((b, pg), dtype=dtype, device=device)
        vmask6 = torch.ones((b, v, 6), dtype=dtype, device=device)

    a_blk = jac[..., :pg] * gmask[:, None, None, :]
    b_blk = jac[..., pg:] * vmask6[:, :, None, :]
    u = torch.einsum("bvmi,bvmj->bij", a_blk, a_blk) + torch.diag_embed(1.0 - gmask)
    wv = torch.einsum("bvmi,bvmj->bvij", a_blk, b_blk)  # (B, V, pg, 6)
    vb = torch.einsum("bvmi,bvmj->bvij", b_blk, b_blk) + torch.diag_embed(1.0 - vmask6)

    vinv = linalg.spd_inverse(vb)  # (B, V, 6, 6)
    wvinv = wv @ vinv  # W_v V_v^-1
    s_mat = u - torch.einsum("bvik,bvjk->bij", wvinv, wv)
    c_gg = linalg.spd_inverse(s_mat)  # (B, pg, pg)
    q = torch.einsum("bij,bvjk->bvik", c_gg, wvinv)  # S^-1 W_v V_v^-1
    c_gv = -q
    c_vv = torch.einsum("bvki,bwkj->bvwij", wvinv, q)  # (B, V, V, 6, 6)
    diag = torch.arange(v, device=device)
    c_vv[:, diag, diag] += vinv

    # grouped layout [pg | (rot, tra) per view], then permute to the
    # manifold layout [pg | 3V rot | 3V tra]
    top = torch.cat([c_gg, c_gv.permute(0, 2, 1, 3).reshape(b, pg, 6 * v)], dim=2)
    bottom = torch.cat(
        [
            c_gv.transpose(-1, -2).reshape(b, 6 * v, pg),
            c_vv.permute(0, 1, 3, 2, 4).reshape(b, 6 * v, 6 * v),
        ],
        dim=2,
    )
    cg = torch.cat([top, bottom], dim=1)
    gidx = np.concatenate(
        [np.arange(pg)]
        + [pg + 6 * i + np.arange(3) for i in range(v)]
        + [pg + 6 * i + 3 + np.arange(3) for i in range(v)]
    )
    gidx = torch.as_tensor(gidx, device=device)
    c_t = cg[:, gidx][:, :, gidx]
    if tan_free is not None:
        c_t = c_t * tan_free[:, :, None] * tan_free[:, None, :]
    return c_t, torch.isfinite(c_t).all(dim=-1).all(dim=-1)


def lm_core_schur(
    residual_fn: Callable,
    jac_fn: Callable,
    xg0,
    quats0,
    trans0,
    view_data,
    *,
    options: OptimOptions = OptimOptions(),
    g_free=None,
    view_valid=None,
    lower_g=None,
    g_manifold=None,
    blocks_per_view: int = 1,
    jac_dtype=None,
) -> SchurOutput:
    """Minimize 0.5 * sum_v rho(|r_v|^2) over (global, per-view pose) blocks
    for a batch of B independent problems.

    Args:
      residual_fn: (xg (B, pg), quats (B, V, 4), trans (B, V, 3),
        *view_data) -> (B, V, m) residuals, masked rows zeroed.
      jac_fn: same arguments -> (B, V, m, pg + 6) tangent Jacobian of the
        retracted residual at zero tangent, columns [global tangent,
        rotation omega (3), translation (3)]; the rotation retraction is the
        right multiplied quaternion exp, and the global one
        ``g_manifold.retract`` (or addition). An analytic one, or
        ``view_jacobian_fn(residual_fn)`` for any residual with a Euclidean
        global block.
      xg0, quats0, trans0: initial global (ambient, (B, ga)) and per-view
        pose blocks.
      view_data: tuple of (B, V, ...) tensors passed to both functions.
      g_free: optional (ga,) or (B, ga) ambient mask of free global
        coordinates, mapped to tangent dims through ``g_manifold``.
      view_valid: optional (B, V); invalid views get frozen pose blocks
        (their residuals stay in the cost: that is the caller's mask).
      lower_g: optional (ga,) or (B, ga) lower bounds on the ambient global
        block.
      g_manifold: optional ProductManifold of the global block; None means
        Euclidean (pg = ga).
      blocks_per_view: Huber loss blocks per view (C for a C-camera rig).
      jac_dtype: optional dtype (torch.float32) of the Jacobian and the
        grams built from it only; the iterate, residuals, cost and the
        acceptance test stay in the state's dtype, so every accepted step
        lowers the true cost and only the step direction is approximate.
        Pair such a phase with a full-precision polish
        (``optimize_intrinsics_device(precision="mixed_jac")``). None: the
        state's dtype.
    """
    eps = options.epsilon
    huber = options.huber_delta
    max_it = options.max_iterations
    dtype, device = xg0.dtype, xg0.device
    b = xg0.shape[0]
    pg = _global_tangent_dim(xg0, g_manifold)
    v = quats0.shape[-2]

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    if g_free is None:
        gmask = ones(b, pg)
    elif g_manifold is not None:
        gmask = g_manifold.ambient_to_tangent_mask(g_free.bool()).to(dtype).expand(b, pg)
    else:
        gmask = g_free.to(dtype).expand(b, pg)
    vmask = ones(b, v) if view_valid is None else view_valid.to(dtype)
    vmask6 = vmask[..., None].expand(b, v, 6)
    lo = None if lower_g is None else lower_g.to(dtype)
    view_data = tuple(view_data)
    # what every segment reads besides its arguments, as k: (gmask, vmask6,
    # diag(gmask), diag(vmask6), diag(1 - gmask), diag(1 - vmask6), lo,
    # *view_data)
    consts = (gmask, vmask6, torch.diag_embed(gmask), torch.diag_embed(vmask6), torch.diag_embed(1.0 - gmask),
              torch.diag_embed(1.0 - vmask6), lo) + view_data
    # forward-mode Jacobians keep host state (dual levels, the lock): they
    # are marked ``lm_graphs.eager`` and get no key
    key = lm_graphs.key(
        (residual_fn, jac_fn, options, None if g_manifold is None else g_manifold.blocks, blocks_per_view,
         jac_dtype),
        (xg0, quats0, trans0, g_free, view_valid, lower_g) + view_data,
    )
    seg = lm_graphs.solve("schur", key, consts, device)
    gdt = dtype if jac_dtype is None else jac_dtype

    def clip_g(k, xg):
        return xg if k[6] is None else torch.maximum(xg, k[6])

    def g_retract(xg, dg):
        return xg + dg if g_manifold is None else g_manifold.retract(xg, dg)

    def residuals(k, xg, quats, trans):
        return residual_fn(xg, quats, trans, *k[7:])

    def weights(r):
        return _huber(r, huber, blocks_per_view)

    def init_segment(k, xg0, quats0, trans0):
        xg = clip_g(k, xg0)
        r = residuals(k, xg, quats0, trans0)
        return xg, r, weights(r)[1]

    def linearize_segment(k, xg, quats, trans, r, cost, mu, nu, it, done):
        """One LINEARIZATION at the current iterate: the trials' cache
        (xg ... outer) and their carry (t_xg ... go). The Jacobian and its
        grams in gdt, the system in the state's dtype."""
        gmask, vmask6, diag_gfixed, diag_vfixed = k[0], k[1], k[4], k[5]
        view_data_j = tuple(d.to(gdt) if d.is_floating_point() else d for d in k[7:])
        jac = jac_fn(xg.to(gdt), quats.to(gdt), trans.to(gdt), *view_data_j)  # (B, V, m, pg + 6)
        w, _ = weights(r)
        sw = torch.sqrt(w)
        rw = (r * sw).to(gdt)
        jw = jac * sw[..., None].to(gdt)
        a_blk = jw[..., :pg] * gmask[:, None, None, :].to(gdt)
        b_blk = jw[..., pg:] * vmask6[:, :, None, :].to(gdt)
        u = torch.einsum("bvmi,bvmj->bij", a_blk, a_blk).to(dtype)
        wmat = torch.einsum("bvmi,bvmj->bvij", a_blk, b_blk).to(dtype)
        vb = torch.einsum("bvmi,bvmj->bvij", b_blk, b_blk).to(dtype)
        gu = torch.einsum("bvmi,bvm->bi", a_blk, rw).to(dtype)
        gv = torch.einsum("bvmi,bvm->bvi", b_blk, rw).to(dtype)

        grad_max = torch.maximum(gu.abs().amax(dim=-1), gv.abs().amax(dim=(-2, -1)))
        gtol_hit = grad_max <= eps

        diag_u, dg = _jacobi(u, gmask)
        diag_v, dv = _jacobi(vb, vmask6)

        # Jacobi-scaled damped system; frozen dims get a unit diagonal so
        # every factorization stays SPD (their delta is zeroed afterwards)
        u_s = dg[:, :, None] * u * dg[:, None, :] + diag_gfixed
        w_s = dg[:, None, :, None] * wmat * dv[:, :, None, :]
        v_s = dv[..., :, None] * vb * dv[..., None, :] + diag_vfixed
        gu_s = dg * gu
        gv_s = dv * gv
        # over the ambient blocks, a rig's camera quaternions included
        x_norm = torch.sqrt(
            torch.sum(xg**2, dim=-1) + torch.sum(quats**2, dim=(-2, -1)) + torch.sum(trans**2, dim=(-2, -1))
        )

        outer, *control = _first_trial(done, it, max_it)
        return (xg, quats, trans, cost, u_s, w_s, v_s, gu_s, gv_s, gu, gv, diag_u, diag_v, dg, dv, gtol_hit, x_norm,
                outer, xg, quats, trans, r, cost, mu, nu, it, *control)

    def trial_segment(k, xg, quats, trans, cost, u_s, w_s, v_s, gu_s, gv_s, gu, gv, diag_u, diag_v, dg, dv,
                      gtol_hit, x_norm, outer,
                      t_xg, t_quats, t_trans, t_r, t_cost, t_mu, t_nu, t_it, accepted, t_term, active, go):
        """One damped Schur re-solve of the cached linearization: the new
        carry, with the next trial's ``active`` lanes and whether there
        are any."""
        gmask, vmask6, diag_gmask, diag_vmask6 = k[:4]
        u_mu = u_s + t_mu[:, None, None] * diag_gmask
        v_mu = v_s + t_mu[:, None, None, None] * diag_vmask6
        v_inv = linalg.spd_inverse(v_mu)  # (B, V, 6, 6)
        wvinv = w_s @ v_inv  # (B, V, pg, 6)
        s_mat = u_mu - torch.einsum("bvik,bvjk->bij", wvinv, w_s)
        rhs = -(gu_s - torch.einsum("bvik,bvk->bi", wvinv, gv_s))
        dg_t = linalg.spd_solve(s_mat, rhs)
        dv_t = -torch.einsum("bvij,bvj->bvi", v_inv, gv_s + torch.einsum("bvji,bj->bvi", w_s, dg_t))

        delta_g = dg * dg_t * gmask
        delta_v = dv * dv_t * vmask6
        delta_ok = torch.isfinite(delta_g).all(dim=-1) & torch.isfinite(delta_v).all(dim=-1).all(dim=-1)
        delta_g = _sel(delta_ok, delta_g, torch.zeros_like(delta_g))
        delta_v = _sel(delta_ok, delta_v, torch.zeros_like(delta_v))

        step_norm = torch.sqrt(torch.sum(delta_g**2, dim=-1) + torch.sum(delta_v**2, dim=(-2, -1)))
        xtol_hit = delta_ok & (step_norm <= eps * (x_norm + eps))

        xg_new = clip_g(k, g_retract(xg, delta_g))
        q_new, tr_new = _retract_views(quats, trans, delta_v)
        r_new = residuals(k, xg_new, q_new, tr_new)
        _, cost_new = weights(r_new)

        pred = 0.5 * (
            torch.sum(delta_g * (t_mu[:, None] * diag_u * delta_g - gu), dim=-1)
            + torch.sum(delta_v * (t_mu[:, None, None] * diag_v * delta_v - gv), dim=(-2, -1))
        )
        accept, *control = _nielsen(options, cost, cost_new, pred, delta_ok, xtol_hit, gtol_hit, outer,
                                    t_mu, t_nu, t_it, accepted, t_term, active)
        return (_sel(accept, xg_new, t_xg), _sel(accept, q_new, t_quats), _sel(accept, tr_new, t_trans),
                _sel(accept, r_new, t_r), _sel(accept, cost_new, t_cost), *control)

    def step(state):
        return _lm_step(seg, "schur", linearize_segment, trial_segment, _CACHE_LEN, *state)

    def cond(state):
        kept, done = state[:2]
        return ~done & (kept[-1] < max_it)

    with seg.held():
        xg, r, cost0 = (seg.own(t) for t in seg.run("init", init_segment, xg0, quats0, trans0))
    mu, nu, it, done, termination, lin = _first_state(b, dtype, device)
    init = ((xg, quats0, trans0, r, cost0, mu, nu, it), done, termination, lin, ())
    (xg, quats, trans, _, cost, _, _, it), _, termination, lin, _ = _lm_run("schur", init, step, cond)
    return SchurOutput(
        xg=xg,
        quats=quats,
        trans=trans,
        cost=cost,
        initial_cost=cost0,
        iterations=it,
        termination=termination,
        success=termination > 0,
        linearizations=lin,
    )
