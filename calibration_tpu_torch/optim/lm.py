"""The dense Levenberg-Marquardt engine ``lm_core``, its ``covariance``, and
the LM's control, which the Schur engine runs too (port of
``calibration_tpu/optim/lm.py``).

``lm_core`` minimizes 0.5 * sum rho(|r_b|^2) over a product manifold for a
batch of B independent problems: tangent-space Jacobians (a caller's
analytic ``jac_fn``, or forward-mode autodiff of the retracted residual),
Huber IRLS weights per residual block, Jacobi-scaled damped normal
equations with Marquardt damping and the Nielsen mu-update, box bounds by
projection after each retraction, and frozen coordinates through a free
mask. ftol, gtol and xtol are all ``OptimOptions.epsilon``, gtol before
xtol before ftol, and a lane succeeds iff it stops by a tolerance.

The reference vmaps one problem's ``lax.while_loop`` over the batch. Here,
as in ``optim/lm_schur.py``, the loops are Python loops over the whole
batch with per-lane masks: a finished lane keeps every field, its counters
included; the linearization is cached across rejected trials (a rejected
trial re-solves the cached system with a larger mu); the host reads one
flag per trial to decide whether any lane is still active.

Both engines run one control, written here: the Huber block weights, the
Jacobi scaling, the Nielsen trial update with its termination codes, and
the host's loop of linearizations and damping retries (``_lm_step``,
``_lm_run``). They differ in their normal equations, their damped solve,
their retraction and the layout of their state.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops import linalg
from ..utils import profiling
from . import lm_graphs
from .core import OptimOptions
from .manifold import ProductManifold

# Initial Nielsen damping for the Jacobi-scaled system (diag ~ 1, so this is
# tau directly): the reference's measured default, fixed here (the
# reference's CALIB_LM_MU_INIT override is not ported).
_MU_INIT = 1e-6
_MU_MIN = 1e-32
_MU_MAX = 1e32

# PyTorch keeps forward-mode AD levels per process, not per thread: two
# threads inside ``forward_ad.dual_level`` (or ``torch.func.jacfwd``, which
# enters one) at once break each other's levels. A mesh over distinct
# devices solves each device's shards on a thread of its own, so every
# forward-mode Jacobian of the port holds this lock; the rest of a solve
# runs unserialised.
FORWARD_AD_LOCK = threading.Lock()


@contextlib.contextmanager
def dual_level():
    """``torch.autograd.forward_ad.dual_level`` under ``FORWARD_AD_LOCK``."""
    with FORWARD_AD_LOCK, fwAD.dual_level():
        yield


class LMOutput(NamedTuple):
    """Batched: every field has a leading problem axis."""

    x: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor  # trials: accepted steps + rejected re-solves
    termination: torch.Tensor  # 0 no-conv, 1 ftol, 2 gtol, 3 xtol, 4 failure
    success: torch.Tensor
    linearizations: torch.Tensor  # residual + Jacobian evaluations


def _loss_blocks(m: int, block_ids, num_blocks: int, device):
    """The rows of each Huber loss block, as (run, ids): blocks that are
    contiguous runs of equal length ``run`` are summed by a reshape (ids
    None); any other map is summed by ``index_add_`` over ``ids``. No
    block_ids is one block of all m rows."""
    if block_ids is None:
        return m, None
    ids = np.asarray(block_ids.cpu() if isinstance(block_ids, torch.Tensor) else block_ids)
    run = m // num_blocks if num_blocks and m % num_blocks == 0 else 0
    if run and np.array_equal(ids, np.repeat(np.arange(num_blocks), run)):
        return run, None
    return None, torch.as_tensor(ids, dtype=torch.long, device=device)


def _huber_blocks(s, huber_delta: float):
    """Huber IRLS weights (B, n) and robust cost (B,) of per-block squared
    norms s = |r_b|^2 (B, n): weight 1 inside the delta ball and
    delta/|r_b| outside; cost 0.5 * sum rho(|r_b|^2)."""
    d2 = huber_delta * huber_delta
    out = s > d2
    sqrt_s = torch.sqrt(torch.clamp(s, min=1e-300))
    wb = torch.where(out, huber_delta / sqrt_s, torch.ones_like(s))
    rho = torch.where(out, 2.0 * huber_delta * sqrt_s - d2, s)
    return wb, 0.5 * torch.sum(rho, dim=-1)


def _robust_weights(r, blocks, num_blocks: int, huber_delta: float):
    """Huber IRLS row weights (B, m) and robust cost (B,) of residuals
    r (B, m), per loss block (``_huber_blocks``)."""
    run, ids = blocks
    b, m = r.shape
    run = run or m  # no block_ids: one block of all rows
    if ids is None:
        s = torch.sum((r * r).reshape(b, m // run, run), dim=-1)
    else:
        s = torch.zeros((b, num_blocks), dtype=r.dtype, device=r.device).index_add_(1, ids, r * r)
    wb, cost = _huber_blocks(s, huber_delta)
    return (wb.repeat_interleave(run, dim=-1) if ids is None else wb[:, ids]), cost


def _jacobi(a, free):
    """(diag, d) of normal matrices a (..., n, n) under a free mask
    (..., n): the diagonal clamped to [1e-12, 1e32], 1 on frozen dims, and
    the Jacobi scale d = diag^-1/2, 0 on frozen dims."""
    diag = torch.clamp(torch.diagonal(a, dim1=-2, dim2=-1), 1e-12, 1e32) * free + (1.0 - free)
    return diag, torch.where(free > 0, 1.0 / torch.sqrt(diag), 0.0)


def _sel(mask, a, b):
    """``a`` where the lane mask (B,) holds, else ``b``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def _first_state(b: int, dtype, device) -> tuple:
    """(mu, nu, it, done, termination, lin) of a solve's first state."""
    it = torch.zeros((b,), dtype=torch.int64, device=device)
    return (torch.full((b,), _MU_INIT, dtype=dtype, device=device), torch.full((b,), 2.0, dtype=dtype, device=device),
            it, torch.zeros((b,), dtype=torch.bool, device=device), torch.zeros_like(it), torch.zeros_like(it))


def _first_trial(done, it, max_it: int) -> tuple:
    """(outer, accepted, t_term, active, go) of a linearization: the lanes
    in the outer loop, and the control fields of its first trial's carry."""
    outer = ~done & (it < max_it)
    accepted = torch.zeros_like(done)
    t_term = torch.zeros_like(it)
    active = outer & ~accepted & (t_term == 0) & (it < max_it)
    return outer, accepted, t_term, active, active.any()


def _nielsen(options: OptimOptions, cost, cost_new, pred, delta_ok, xtol_hit, gtol_hit, outer,
             mu, nu, it, accepted, t_term, active) -> tuple:
    """One trial's acceptance and Nielsen update, per lane: the trial is
    accepted where it is finite and lowers the cost by a positive share
    ``rho`` of the predicted decrease ``pred``; mu shrinks by Nielsen's
    factor on acceptance and grows by nu on rejection; termination codes
    gtol (2) before xtol (3) before ftol (1). Lanes outside ``active`` keep
    every field. Returns (accept, mu, nu, it, accepted, t_term, the next
    trial's active lanes, whether there are any)."""
    eps, max_it = options.epsilon, options.max_iterations
    rho = (cost - cost_new) / torch.where(pred > 0, pred, 1e-300)
    accept = active & delta_ok & torch.isfinite(cost_new) & (rho > 0) & (pred > 0)
    ftol_hit = accept & (torch.abs(cost - cost_new) <= eps * cost)

    factor = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    mu_acc = torch.clamp(mu * factor, _MU_MIN, _MU_MAX)
    mu_rej = torch.clamp(mu * nu, _MU_MIN, _MU_MAX)
    term = torch.where(
        gtol_hit, 2, torch.where(xtol_hit, 3, torch.where(ftol_hit, 1, 0))
    ).to(t_term.dtype)

    mu = torch.where(active, torch.where(accept, mu_acc, mu_rej), mu)
    nu = torch.where(active, torch.where(accept, 2.0, nu * 2.0), nu)
    it = torch.where(active, it + 1, it)
    accepted = accepted | accept
    t_term = torch.where(active, term, t_term)
    active = outer & ~accepted & (t_term == 0) & (it < max_it)
    return accept, mu, nu, it, accepted, t_term, active, active.any()


def _lm_step(seg, prefix: str, linearize_segment: Callable, trial_segment: Callable, n_cache: int,
             kept: tuple, done, termination, lin, gated: tuple = ()) -> tuple:
    """One LINEARIZATION of either engine and its damping-retry loop, for
    the lanes in the outer loop; every other lane keeps every field.

    ``kept`` is what the trials carry: the engine's iterate and the
    fields it keeps with it, then (cost, mu, nu, it).
    ``linearize_segment(k, *kept, done)`` returns (*gated, *cache,
    *kept, accepted, t_term, active, go): per-linearization fields, the
    trials' cache of ``n_cache`` tensors (``outer`` last) and the first
    trial's carry (``_first_trial``); ``trial_segment(k, *cache,
    *carry)`` returns the next carry (``_nielsen``). The host reads one
    flag per trial. Returns (kept, done, termination, lin, gated), the
    ``gated`` fields taken from this linearization where the lane was in
    the outer loop.
    """
    ng = len(gated)
    with seg.held():
        with profiling.span(prefix + ".linearize"):
            out = seg.run("linearize", linearize_segment, *kept, done)
        new_gated, cache, carry = out[:ng], out[ng:ng + n_cache], out[ng + n_cache:]
        # inner damping-retry loop on the cached linearization
        while True:
            with profiling.sync(prefix + ".trial"):
                go = bool(carry[-1])
            if not go:
                break
            with profiling.span(prefix + ".trial"):
                carry = seg.run("trial", trial_segment, *cache, *carry, update_from=n_cache)
        outer, t_term = cache[-1], carry[-3]
        # lanes outside the outer loop never went active: their carry is
        # their own state, so only the per-linearization fields need gating
        return (
            tuple(seg.own(t) for t in carry[:-4]),
            torch.where(outer, t_term > 0, done),
            torch.where(outer, t_term, termination),
            lin + outer.to(lin.dtype),
            tuple(torch.where(outer, g, old) for g, old in zip(new_gated, gated)),
        )


def _lm_run(prefix: str, state, step: Callable, cond: Callable):
    """``step`` from ``state`` while any lane of ``cond(state)`` holds: the
    host reads one flag per linearization. Returns the last state."""
    while True:
        with profiling.sync(prefix + ".outer"):
            go = bool(cond(state).any())
        if not go:
            return state
        state = step(state)


def tangent_jacobian(residual_fn: Callable, manifold: ProductManifold, x, data=(), lower=None, upper=None):
    """(r (B, m), jac (B, m, t)): the residuals at x and their Jacobian in
    the manifold tangent at zero, d r(clip(retract(x, d))) / d d, by
    forward-mode autodiff per lane (``torch.func.vmap`` of ``jacfwd``).

    ``residual_fn(x (B, a), *data)`` is batched; each lane sees it with a
    batch of one. ``lower``/``upper`` (broadcastable to x) clip the
    retracted point, as the LM's iterate is clipped."""
    bounds = [t.to(x.dtype).expand(x.shape) for t in (lower, upper) if t is not None]
    has_lower = lower is not None

    def lane(d, x1, *rest):
        lohi, dat = rest[: len(bounds)], rest[len(bounds):]
        xr = manifold.retract(x1, d)[None]
        for k, bound in enumerate(lohi):
            xr = torch.maximum(xr, bound) if (k == 0 and has_lower) else torch.minimum(xr, bound)
        r = residual_fn(xr, *(t[None] for t in dat))[0]
        return r, r

    zero = torch.zeros(x.shape[:-1] + (manifold.tangent_dim,), dtype=x.dtype, device=x.device)
    with FORWARD_AD_LOCK:
        jac, r = torch.func.vmap(torch.func.jacfwd(lane, has_aux=True))(zero, x, *bounds, *data)
    return r, jac


def dual_jacobian_fn(residual_fn: Callable, manifold: ProductManifold, lower=None, upper=None) -> Callable:
    """A ``jac_fn`` for ``lm_core`` and ``covariance``: the Jacobian of
    ``tangent_jacobian`` by dual numbers instead of ``vmap(jacfwd)``. The
    t tangent sweeps run as ONE evaluation of ``residual_fn`` on the batch
    repeated t times, copy c carrying unit tangent c (the idiom of
    ``lm_schur.view_jacobian_fn``). Optional (a,) ``lower``/``upper`` clip
    the retracted point, as in ``tangent_jacobian``."""

    def jac_fn(x, *data):
        b, t = x.shape[0], manifold.tangent_dim
        eye = torch.eye(t, dtype=x.dtype, device=x.device)

        def rep(a):  # (B, ...) -> (t * B, ...), copy c carries column c
            return a.expand((t,) + a.shape).reshape((t * a.shape[0],) + a.shape[1:])

        with dual_level():
            d = fwAD.make_dual(x.new_zeros((t * b, t)), eye[:, None, :].expand(t, b, t).reshape(t * b, t))
            xr = manifold.retract(rep(x), d)
            if lower is not None:
                xr = torch.maximum(xr, lower.to(x.dtype))
            if upper is not None:
                xr = torch.minimum(xr, upper.to(x.dtype))
            jac = fwAD.unpack_dual(residual_fn(xr, *(rep(a) for a in data))).tangent  # (t * B, m)
        return jac.reshape(t, b, -1).permute(1, 2, 0)

    return jac_fn


def _tan_free(manifold: ProductManifold, free_mask, b: int, dtype, device):
    if free_mask is None:
        return torch.ones((b, manifold.tangent_dim), dtype=dtype, device=device)
    mask = manifold.ambient_to_tangent_mask(free_mask.bool())
    return mask.to(dtype).expand(b, manifold.tangent_dim)


class LMState(NamedTuple):
    """The dense LM between linearizations, batched: every field has a
    leading problem axis."""

    x: torch.Tensor  # ambient parameters
    mu: torch.Tensor  # damping
    nu: torch.Tensor  # damping growth factor
    cost: torch.Tensor
    it: torch.Tensor  # trials: accepted steps + rejected re-solves
    done: torch.Tensor
    termination: torch.Tensor  # TerminationType code
    grad_max: torch.Tensor  # at the last linearization
    lin: torch.Tensor  # linearizations


def make_lm_step(
    residual_fn: Callable,
    x0,
    manifold: ProductManifold,
    *,
    data: tuple = (),
    options: OptimOptions = OptimOptions(),
    free_mask=None,
    block_ids=None,
    num_blocks: int = 0,
    lower=None,
    upper=None,
    jac_fn: Optional[Callable] = None,
) -> tuple[LMState, Callable, Callable]:
    """One LM iteration as a function ``LMState -> LMState``.

    Returns (init_state, step, cond): ``lm_core`` runs ``step`` while any
    lane of ``cond(state)`` (B,) is true; a profiling caller may step it
    itself (``utils.profiling.lm_cost_trace``) and see the same
    trajectory. One step is one LINEARIZATION at the current iterate and
    its inner damping-retry loop, which re-solves the cached system with a
    larger mu after each rejected trial, for the lanes where ``cond`` holds;
    every other lane keeps every field.

    The device work falls in three segments of fixed shapes: the initial
    cost, a linearization, a trial. With an analytic ``jac_fn`` on CUDA and
    a key for the solve (``lm_graphs``), each is a CUDA graph from the
    key's second solve on; the host's flag reads between them stay.

    Args: see ``lm_core``.
    """
    eps = options.epsilon
    huber = options.huber_delta
    max_it = options.max_iterations
    dtype, device = x0.dtype, x0.device
    b = x0.shape[0]
    tan_free = _tan_free(manifold, free_mask, b, dtype, device)
    lo = None if lower is None else lower.to(dtype)
    up = None if upper is None else upper.to(dtype)
    run, ids = _loss_blocks(None if block_ids is None else len(block_ids), block_ids, num_blocks, device)
    nb = num_blocks if block_ids is not None else 1
    data = tuple(data)
    # what every segment reads besides its arguments, as k: (tan_free,
    # diag_free, diag_fixed, lo, up, ids, *data)
    consts = (tan_free, torch.diag_embed(tan_free), torch.diag_embed(1.0 - tan_free), lo, up, ids) + data
    # forward-mode Jacobians keep host state (dual levels, the lock): eager
    key = None if jac_fn is None else lm_graphs.key(
        (residual_fn, jac_fn, manifold.blocks, options, run, nb), (x0, free_mask, lo, up, ids) + data
    )
    seg = lm_graphs.solve("dense", key, consts, device)

    def clip_x(k, x):
        lo, up = k[3], k[4]
        if lo is not None:
            x = torch.maximum(x, lo)
        if up is not None:
            x = torch.minimum(x, up)
        return x

    def residuals(k, x):
        return residual_fn(x, *k[6:])

    def linearize(k, x):
        if jac_fn is not None:
            # assumes the box bounds are inactive at the iterate (Ceres'
            # interior linearization), as the reference does
            return residuals(k, x), jac_fn(x, *k[6:])
        return tangent_jacobian(residual_fn, manifold, x, k[6:], k[3], k[4])

    def cost_of(k, r):
        if huber > 0:
            return _robust_weights(r, (run, k[5]), nb, huber)[1]
        return 0.5 * torch.sum(r * r, dim=-1)

    def weighted(k, r, jac):
        if huber > 0:
            sw = torch.sqrt(_robust_weights(r, (run, k[5]), nb, huber)[0])
            return r * sw, jac * sw[..., None]
        return r, jac

    def cond(state: LMState):
        return ~state.done & (state.it < max_it)

    def init_segment(k, x0):
        x = clip_x(k, x0)
        return x, cost_of(k, residuals(k, x))

    def linearize_segment(k, x, cost, mu, nu, it, done):
        """(grad_max, the trials' cache (x ... outer), the trials' carry
        (t_x ... go))."""
        tan_free, diag_fixed = k[0], k[2]
        r_lin, jac = linearize(k, x)
        rw, jw = weighted(k, r_lin, jac)
        jw = jw * tan_free[:, None, :]
        g = torch.einsum("bmi,bm->bi", jw, rw)
        a = jw.transpose(-1, -2) @ jw

        grad_max = g.abs().amax(dim=-1)
        gtol_hit = grad_max <= eps
        # Jacobi-scaled damped normal equations: with D = diag(A)^-1/2 the
        # scaled system has unit diagonal, so the damping is mu * I and the
        # Cholesky sees cond(D A D); frozen dims get a unit diagonal so the
        # factorization stays SPD (their delta is zeroed)
        diag, d = _jacobi(a, tan_free)
        a_s = d[:, :, None] * a * d[:, None, :] + diag_fixed
        x_norm = torch.linalg.norm(x, dim=-1)

        outer, *control = _first_trial(done, it, max_it)
        return (grad_max, x, cost, g, d, a_s, diag, x_norm, gtol_hit, outer, x, cost, mu, nu, it, *control)

    def trial_segment(k, x, cost, g, d, a_s, diag, x_norm, gtol_hit, outer,
                      t_x, t_cost, t_mu, t_nu, t_it, accepted, t_term, active, go):
        """One damped re-solve of the cached system: the new carry, with
        the next trial's ``active`` lanes and whether there are any."""
        tan_free, diag_free = k[0], k[1]
        sys = a_s + t_mu[:, None, None] * diag_free
        delta = -d * linalg.spd_solve(sys, d * g) * tan_free
        delta_ok = torch.isfinite(delta).all(dim=-1)
        delta = _sel(delta_ok, delta, torch.zeros_like(delta))

        step_norm = torch.linalg.norm(delta, dim=-1)
        xtol_hit = delta_ok & (step_norm <= eps * (x_norm + eps))

        x_new = clip_x(k, manifold.retract(x, delta))
        cost_new = cost_of(k, residuals(k, x_new))
        pred = 0.5 * torch.sum(delta * (t_mu[:, None] * diag * delta - g), dim=-1)
        accept, *control = _nielsen(options, cost, cost_new, pred, delta_ok, xtol_hit, gtol_hit, outer,
                                    t_mu, t_nu, t_it, accepted, t_term, active)
        return (_sel(accept, x_new, t_x), _sel(accept, cost_new, t_cost), *control)

    def step(state: LMState) -> LMState:
        # a cache of 9: x ... outer
        (x, cost, mu, nu, it), done, termination, lin, (grad_max,) = _lm_step(
            seg, "dense", linearize_segment, trial_segment, 9, (state.x, state.cost, state.mu, state.nu, state.it),
            state.done, state.termination, state.lin, (state.grad_max,),
        )
        return LMState(x, mu, nu, cost, it, done, termination, grad_max, lin)

    with seg.held():
        x_init, cost = (seg.own(t) for t in seg.run("init", init_segment, x0))
    mu, nu, it, done, termination, lin = _first_state(b, dtype, device)
    grad_max = torch.full((b,), torch.inf, dtype=dtype, device=device)
    return LMState(x_init, mu, nu, cost, it, done, termination, grad_max, lin), step, cond


def lm_output(init: LMState, final: LMState) -> LMOutput:
    """The ``LMOutput`` of a run of ``make_lm_step`` from ``init`` to
    ``final``."""
    return LMOutput(
        x=final.x,
        cost=final.cost,
        initial_cost=init.cost,
        iterations=final.it,
        termination=final.termination,
        success=final.termination > 0,
        linearizations=final.lin,
    )


def lm_core(
    residual_fn: Callable,
    x0,
    manifold: ProductManifold,
    *,
    data: tuple = (),
    options: OptimOptions = OptimOptions(),
    free_mask=None,
    block_ids=None,
    num_blocks: int = 0,
    lower=None,
    upper=None,
    jac_fn: Optional[Callable] = None,
) -> LMOutput:
    """Minimize 0.5 * sum rho(|r|^2) over the manifold, for B problems:
    ``make_lm_step``'s step while any lane's ``cond`` holds (the host reads
    one flag per linearization and one per trial).

    Args:
      residual_fn: (x (B, a), *data) -> (B, m) residuals (masked rows
        zeroed by the caller).
      x0: (B, a) initial ambient parameters.
      manifold: parameter-block structure of one problem.
      data: tuple of (B, ...) tensors passed to residual_fn and jac_fn.
      free_mask: optional (a,) or (B, a) bool; False coordinates are frozen.
      block_ids: optional (m,) robust-loss block id per residual row (numpy
        or tensor, shared by the lanes); None is one block when
        huber_delta > 0.
      num_blocks: count of robust-loss blocks.
      lower/upper: optional (a,) or (B, a) box bounds, enforced by
        projection after each retraction.
      jac_fn: optional analytic tangent Jacobian, (x, *data) -> (B, m, t);
        it must equal ``tangent_jacobian`` of the residual. None ->
        forward-mode autodiff.
    """
    init, step, cond = make_lm_step(
        residual_fn, x0, manifold, data=data, options=options, free_mask=free_mask, block_ids=block_ids,
        num_blocks=num_blocks, lower=lower, upper=upper, jac_fn=jac_fn,
    )
    return lm_output(init, _lm_run("dense", init, step, cond))


@profiling.traced("dense.covariance")
def covariance(
    residual_fn: Callable,
    x,
    manifold: ProductManifold,
    *,
    data: tuple = (),
    free_mask=None,
    scale_by_variance: bool = False,
    num_residuals=None,
    block_ids=None,
    num_blocks: int = 0,
    huber_delta: float = 0.0,
    jac_r=None,
    jac_fn: Optional[Callable] = None,
):
    """Ambient-space covariance at a solution, for B problems.

    C_tangent = (J^T J)^-1 on the free dims, lifted to C = D C_t D^T with D
    the retract Jacobian. With ``huber_delta`` > 0 the Jacobian rows are
    rescaled by sqrt(rho') per loss block, as the LM weights them, and the
    variance uses the robust cost. ``scale_by_variance`` multiplies by
    ssr / max(1, m - n) with n the ambient parameter count and m
    ``num_residuals`` (a scalar or a (B,) tensor of valid rows; default all
    rows). ``jac_r``: optional precomputed (r, jac). Returns (cov (B, a, a),
    ok (B,)), ok read before the variance scaling.
    """
    dtype, device = x.dtype, x.device
    b = x.shape[0]
    tan_free = _tan_free(manifold, free_mask, b, dtype, device)
    if jac_r is not None:
        r, jac = jac_r
    elif jac_fn is not None:
        r, jac = residual_fn(x, *data), jac_fn(x, *data)
    else:
        r, jac = tangent_jacobian(residual_fn, manifold, x, data)
    jac = jac * tan_free[:, None, :]
    ssr = torch.sum(r * r, dim=-1)
    if huber_delta > 0:
        blocks = _loss_blocks(r.shape[-1], block_ids, num_blocks, device)
        w, robust_cost = _robust_weights(r, blocks, num_blocks if block_ids is not None else 1, huber_delta)
        jac = jac * torch.sqrt(w)[..., None]
        ssr = 2.0 * robust_cost
    a = jac.transpose(-1, -2) @ jac + torch.diag_embed(1.0 - tan_free)
    c_t = linalg.spd_inverse(a) * tan_free[:, :, None] * tan_free[:, None, :]
    d = manifold.lift_jacobian(x)
    cov = d @ c_t @ d.transpose(-1, -2)
    ok = torch.isfinite(cov).all(dim=-1).all(dim=-1)
    if scale_by_variance:
        m = r.shape[-1] if num_residuals is None else num_residuals
        dof = torch.clamp(torch.as_tensor(m, dtype=dtype, device=device) - manifold.ambient_dim, min=1.0)
        cov = cov * (ssr / dof)[:, None, None]
    return cov, ok


def covariance_from_tangent(c_t, x, manifold: ProductManifold, free_mask=None):
    """Lift a tangent covariance into ambient coordinates: C = D C_t D^T
    with D the retract Jacobian. c_t: (..., t, t); x: (..., a).
    Returns (cov (..., a, a), ok (...,))."""
    if free_mask is not None:
        tan_free = manifold.ambient_to_tangent_mask(free_mask).to(x.dtype)
        c_t = c_t * tan_free[..., :, None] * tan_free[..., None, :]
    d = manifold.lift_jacobian(x)
    cov = d @ c_t @ d.transpose(-1, -2)
    return cov, torch.isfinite(cov).all(dim=-1).all(dim=-1)
