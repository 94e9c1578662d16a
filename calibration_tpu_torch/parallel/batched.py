"""Batched homography, planar-intrinsics, extrinsics, hand-eye, planar-pose,
bundle and line-scan entry points (port of
``calibration_tpu/parallel/batched.py``).

The reference lifts single-problem cores over a problem axis with
``jax.vmap`` inside one jitted program. Here every core already takes a
leading problem axis and runs eagerly on the tensors' device; ``lax.cond``
between phases becomes a host decision. Every entry point takes the
reference's parameters in its order. With a ``mesh`` (``sharding.Mesh``)
the batch is padded to the mesh size, split, each shard solved on its own
device (one host thread per distinct device), and the results gathered on
the mesh's first device (``_on_mesh``); as in the reference, a mesh turns the phased
schedules off unless ``two_phase`` asks for them. Camera models a path
does not take raise ``NotImplementedError`` (``check_ported``: the
intrinsics, extrinsics and line-scan paths take every registry model,
bundle_batch pinhole, as the reference's), and ``analytic_jac`` is
accepted for any value (the analytic Jacobians equal jacfwd to 1e-10;
other models always use forward-mode autodiff).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch
from torch.utils import _pytree as pytree

from ..models.registry import PINHOLE, SCHEIMPFLUG, SPECS
from ..ops import handeye_linear, intrinsics_linear, planarpose
from ..ops import homography as H
from ..ops import linescan as ls
from ..ops import planefit
from ..ops.ransac import RansacOptions, ransac_plane
from ..ops.projection_residuals import projection_rms_f32
from ..optim.bundle import BundleOptions, optimize_bundle_device
from ..optim.core import OptimOptions, check_ported
from ..optim.extrinsics import MODELS as EXTRINSICS_MODELS
from ..optim.extrinsics import ExtrinsicOptions, optimize_extrinsics_device
from ..optim.handeye import optimize_handeye_device
from ..optim.homography import homography_covariance_device, optimize_homography_device
from ..optim.intrinsics import MODELS as INTRINSICS_MODELS
from ..optim.intrinsics import (
    IntrinsicsOptimOptions,
    intrinsics_covariance_device,
    optimize_intrinsics_device,
    schur_graphed,
)
from ..optim.lm import LMOutput
from ..optim.planarpose import optimize_planar_pose_device
from ..utils import profiling
from . import sharding as sh

# The reference's measured pinhole defaults (its CALIB_TWO_PHASE_CAP
# override is not ported): run the full batch up to TWO_PHASE_CAP_A
# iterations, then continue only the lanes that have not converged.
TWO_PHASE_CAP_A = 6
TWO_PHASE_MIN_BATCH = 64
# The reference's stereo schedule (its CALIB_EXTR_PHASE_CAP override is not
# ported): the full batch up to EXTRINSICS_PHASE_CAP iterations, then up to
# EXTRINSICS_PHASE_MID more for the unconverged lanes, then the rest.
EXTRINSICS_PHASE_CAP = 5
EXTRINSICS_PHASE_MID = 8
# The homography batch runs every lane up to HOMOG_PHASE_CAP iterations,
# then only the unconverged lanes. Measured on an H100 (tools/
# profile_torch_cells.py, config 1 at B = 8192, 7 interleaved warm calls
# per setting): medians 36.0 / 35.8 / 35.1 / 33.3 / 34.5 ms at caps 2-6
# and 32.9 ms in one phase. The host-driven loop costs the same per trial
# at any width, so a continuation only adds its restart; 5 is config 1's
# largest trial count, so its phase B is empty. (The reference's TPU-tuned
# cap is 4; its CALIB_HOMOG_PHASE_CAP override is not ported.)
HOMOG_PHASE_CAP = 5
# The bundle batch runs every lane up to BUNDLE_PHASE_CAP iterations, then
# only the unconverged lanes. Measured on an H100 (tools/
# profile_torch_cells.py, config 5 at B = 128, 7 interleaved warm calls per
# setting): medians 88.7 / 82.4 / 77.2 / 74.1 / 76.0 / 80.3 ms at caps 2-6
# and 12, 73.3 ms in one phase. Every config-5 lane takes 4
# linearizations and at most 4 trials, so a lower cap adds restarts; at 5
# the continuation is empty and the call costs what one phase does. (The
# reference's TPU-tuned cap is 12; its CALIB_BUNDLE_PHASE_CAP override is
# not ported.)
BUNDLE_PHASE_CAP = 5
# The Scheimpflug intrinsics run every lane up to a cap, then only the
# unconverged lanes: one cap when fixed_distortion_indices pins some
# coefficients (the reference pins p1 and p2, which makes the tilt
# identifiable: 8-28 linearizations per lane on row 2S), another when every
# coefficient is free (the solve wanders the flat tilt/tangential valley
# for many more). Measured on an H100 (tools/profile_torch_cells.py, row
# 2S's set at B = 256, 7 interleaved warm calls per setting, two runs):
# with p1, p2 fixed, caps 6 / 8 / 10 / 12 / 15 / 20 and one phase gave
# medians 1.512 / 1.174 / 1.064 / 1.055 / 1.079 / 1.167 / 1.187 s, then
# 1.458 / 1.217 / 1.215 / 1.194 / 1.118 / 1.164 / 1.291 s: a flat bottom
# at 10-15; below it restarts add linearizations. With every coefficient
# free, caps 10 / 15 / 20 / 30 / 40 and one phase gave 3.636 / 4.385 /
# 4.024 / 4.022 / 4.002 / 4.217 s, then 3.181 / 3.473 / 3.326 / 3.106 /
# 3.245 / 3.315 s: all inside the calls' spread, 10 lowest or second
# lowest. (The reference's TPU-tuned caps are 12 and 30.)
SCHEIMPFLUG_PHASE_CAP_FIXED = 12
SCHEIMPFLUG_PHASE_CAP_FREE = 10


# A padded later phase of ``_phased_lm`` runs at a power of two of lanes
# from this one up (the intrinsics fleet's graphed Schur solve: 41-46 of
# 256 lanes reach its phase B, which runs at 64).
PAD_LANES_MIN = 16


def _maybe_shard(args, mesh):
    """(one copy of ``args`` per shard of ``mesh``, the real batch size):
    the batch padded with copies of problem 0 to a multiple of the mesh
    size (replicating would cost every shard the whole batch), then split
    over the mesh's devices."""
    if not isinstance(mesh, sh.Mesh):
        raise TypeError(f"mesh must be a calibration_tpu_torch.parallel.Mesh (make_mesh), not {type(mesh).__name__}")
    args, real_b = sh.pad_batch(args, mesh.size)
    return sh.shard_batch(args, mesh), real_b


def _trim(out, real_b):
    """Drop padded problems from every output leaf's leading axis."""
    return pytree.tree_map(lambda x: x[:real_b] if isinstance(x, torch.Tensor) and x.dim() >= 1 else x, out)


def _gather(outs, device):
    """The shards' output trees as one: each tensor leaf concatenated along
    its leading axis on ``device``, NamedTuples leaf by leaf."""
    flat = [pytree.tree_flatten(o)[0] for o in outs]
    leaves = [
        torch.cat([f[i].to(device) for f in flat]) if isinstance(leaf, torch.Tensor) else leaf
        for i, leaf in enumerate(flat[0])
    ]
    return pytree.tree_unflatten(leaves, pytree.tree_flatten(outs[0])[1])


_cuda_linalg_lock = threading.Lock()


@functools.cache
def _load_cuda_linalg(device) -> None:
    """PyTorch loads its CUDA linear-algebra kernels at the process's first
    linalg call on a card, and that first call is not thread-safe: shards
    making it together fail with "lazy wrapper should be called at most
    once" (measured on an H100). One small call on ``device`` before the
    shards' threads start loads them."""
    torch.linalg.cholesky(torch.ones((1, 1), device=device))


def _by_device(devices) -> list:
    """The mesh positions of each distinct device of ``devices``, in the
    order the devices first appear."""
    groups = {}
    for i, d in enumerate(devices):
        groups.setdefault(d, []).append(i)
    return list(groups.values())


def _on_mesh(fn, mesh, args, **kwargs):
    """``fn(*args, **kwargs)`` solved shard by shard over ``mesh``: ``args``
    (the batched arguments) padded and split by ``_maybe_shard``, each
    shard's call under its CUDA device, the outputs gathered on
    ``mesh.devices[0]`` and the padding trimmed. The shards of one device
    are solved in turn on one host thread: every call is host-bound, and
    on an H100 four shards of one card took 4.5x as long on four threads
    as in turn on one (GIL handoffs at every torch operation). Distinct
    devices get a thread each; there the forward-mode Jacobians take
    turns (``lm.FORWARD_AD_LOCK``), and the launch and RANSAC counters and
    the first library loads are locked."""
    shards, real_b = _maybe_shard(args, mesh)
    devices, groups = mesh.devices, _by_device(mesh.devices)
    ctx = profiling.context()

    def run(idx):
        device = devices[idx[0]]
        with profiling.adopt(ctx), torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            return [fn(*shards[i], **kwargs) for i in idx]

    if len(groups) == 1:
        outs = run(groups[0])
    else:
        cuda = [d for d in devices if d.type == "cuda"]
        if cuda:
            with _cuda_linalg_lock:
                _load_cuda_linalg(cuda[0])
        with ThreadPoolExecutor(max_workers=len(groups)) as pool:
            done = list(zip(groups, pool.map(run, groups)))
        outs = [None] * mesh.size
        for idx, group_outs in done:
            for i, o in zip(idx, group_outs):
                outs[i] = o
    return _trim(_gather(outs, devices[0]), real_b)


def _phase_budget(total: int, caps: tuple) -> tuple:
    """Iteration budget of each phase: ``caps`` in turn, then the rest of
    the ``total`` budget; empty phases after the first are dropped. The
    budget is never exceeded (the reference adds a 1-iteration phase when
    the budget is at or below its first cap)."""
    phases = []
    for cap in caps + (total,):
        iters = min(cap, total - sum(phases))
        if iters > 0 or not phases:
            phases.append(iters)
    return tuple(phases)


def _merge_phase(lm_a: LMOutput, sol_a, out_b, idx):
    """Scatter a continuation phase (run on lanes ``idx``, all unconverged
    after phase A) back into phase A's outputs. Counters add up; the
    initial cost stays phase A's."""
    lm_b, sol_b = out_b[0], out_b[1:1 + len(sol_a)]
    part = LMOutput(
        x=lm_b.x,
        cost=lm_b.cost,
        initial_cost=lm_a.initial_cost[idx],
        iterations=lm_a.iterations[idx] + lm_b.iterations,
        termination=lm_b.termination,
        success=lm_b.success,
        linearizations=lm_a.linearizations[idx] + lm_b.linearizations,
    )

    def scat(full, p):
        return full.index_copy(0, idx, p)

    return (
        LMOutput(*(scat(f, p) for f, p in zip(lm_a, part))),
        tuple(scat(s_a, s_b) for s_a, s_b in zip(sol_a, sol_b)),
    )


def _padded_lanes(n: int, full: int) -> int:
    """The lane count a padded later phase runs ``n`` lanes at: the next
    power of two from PAD_LANES_MIN, at most ``full`` (the first phase's
    batch)."""
    lanes = PAD_LANES_MIN
    while lanes < n:
        lanes *= 2
    return min(lanes, full)


def _phased_lm(solve, data_args, init_sol, schedule, layer, pad=False):
    """Phased compacted-batch LM.

    ``solve(iters, *data_args, *feedback)`` returns ``(lm_out,
    *solution_leaves, cov, cov_ok)`` (cov ignored: phased callers defer
    covariance to one final pass). The first phase runs every lane; each
    later phase index-selects the lanes that have not converged (the host
    reads their count once per phase), restarts them from their solution
    (fresh damping, as a new solve) and scatters the results back. The
    first ``len(init_sol)`` solution leaves feed the next phase. Lanes are
    independent, so the result does not depend on which lanes share a
    phase. Returns (lm_out, solution_leaf_tuple).

    ``pad``: run each later phase at ``_padded_lanes`` lanes, the padding
    copies of its first lane, and drop the copies before the merge. The
    count of unconverged lanes changes from call to call; a padded count
    repeats, so a graphed solve (``optim/lm_graphs``) replays its graphs
    there too. A copy converges exactly when its original does, so the
    padding never lengthens the phase.

    ``layer`` ("schur" or "dense") names each phase's span
    (``<layer>.phase``) and the counters of lanes in the first phase
    (``<layer>.lanes``) and sent to a later one (``<layer>.rephased_lanes``,
    padding not counted)."""
    full = init_sol[0].shape[0]
    profiling.count(f"{layer}.lanes", full)
    with profiling.span(f"{layer}.phase"):
        out = solve(schedule[0], *data_args, *init_sol)
    lm_m, sol_m = out[0], tuple(out[1:-2])
    for iters in schedule[1:]:
        with profiling.sync("phase_split"):
            idx = torch.nonzero(~lm_m.success).squeeze(-1)
        n = idx.numel()
        if n == 0:
            break
        profiling.count(f"{layer}.rephased_lanes", n)
        lanes = torch.cat([idx, idx[:1].expand(_padded_lanes(n, full) - n)]) if pad else idx
        fb = tuple(s[lanes] for s in sol_m[: len(init_sol)])
        with profiling.span(f"{layer}.phase"):
            out_b = solve(iters, *(None if d is None else d[lanes] for d in data_args), *fb)
        lm_m, sol_m = _merge_phase(lm_m, sol_m, _trim(out_b, n) if pad else out_b, idx)
    return lm_m, sol_m


def _phased_solve(opts: IntrinsicsOptimOptions, model, precision):
    def solve(iters, obj, uv, mask, view_valid, init_intr, init_poses):
        core = dataclasses.replace(opts.core, compute_covariance=False, max_iterations=iters)
        return optimize_intrinsics_device(
            obj, uv, init_intr, init_poses, mask=mask, model=model,
            opts=dataclasses.replace(opts, core=core), precision=precision, view_valid=view_valid,
        )

    return solve


def _intrinsics_phase_cap(model, opts: IntrinsicsOptimOptions) -> int:
    """The first phase's iteration cap for ``model`` under ``opts``: each
    model's (cap with fixed distortion indices, cap with every coefficient
    free), read when called so a sweep can set the constants."""
    fixed, free = {
        PINHOLE.name: (TWO_PHASE_CAP_A, TWO_PHASE_CAP_A),
        SCHEIMPFLUG.name: (SCHEIMPFLUG_PHASE_CAP_FIXED, SCHEIMPFLUG_PHASE_CAP_FREE),
    }[model.name]
    return fixed if opts.fixed_distortion_indices else free


def _refine(obj, uv, mask, view_valid, init_intr, init_poses, opts, two_phase, model, precision):
    """LM refine (+ covariance): one solve over the batch, or the phased
    solve with covariance deferred to one pass over the merged solution."""
    if not two_phase:
        return optimize_intrinsics_device(
            obj, uv, init_intr, init_poses, mask=mask, model=model, opts=opts, precision=precision,
            view_valid=view_valid,
        )
    lm_m, (intr_m, poses_m, err_m) = _phased_lm(
        _phased_solve(opts, model, precision), (obj, uv, mask, view_valid), (init_intr, init_poses),
        _phase_budget(opts.core.max_iterations, (_intrinsics_phase_cap(model, opts),)), "schur",
        pad=schur_graphed(model, obj.device),
    )
    b, v = obj.shape[0], obj.shape[1]
    if opts.core.compute_covariance:
        cov, cov_ok = intrinsics_covariance_device(
            obj, uv, intr_m, poses_m, mask=mask, model=model, opts=opts, view_valid=view_valid
        )
    else:
        n_amb = model.param_count + 7 * v
        cov = torch.zeros((b, n_amb, n_amb), dtype=obj.dtype, device=obj.device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=obj.device)
    return lm_m, intr_m, poses_m, err_m, cov, cov_ok


def _init_intr(kmtx, model):
    """The seed camera: K, every further parameter (distortion, tilt) zero."""
    zeros = torch.zeros(kmtx.shape[:-1] + (model.param_count - 5,), dtype=kmtx.dtype, device=kmtx.device)
    return torch.cat([kmtx, zeros], dim=-1)


def intrinsics_batch(
    obj_xy,
    img_uv,
    mask=None,
    opts: Optional[IntrinsicsOptimOptions] = None,
    model_name: str = "pinhole_brown_conrady",
    mesh=None,
    precision: str = "f64",
    analytic_jac: bool | None = None,
    two_phase: bool | None = None,
):
    """Zhang seed + LM refine for a batch of B cameras (the path
    ``bench.py`` times).

    obj_xy/img_uv: (B, V, N, 2) float64; mask: (B, V, N). two_phase: None
    -> on for B >= TWO_PHASE_MIN_BATCH without a mesh. ``precision``:
    "f64", "mixed" or "mixed_jac" (``optimize_intrinsics_device``). Returns
    (seed, (LMOutput, intr, poses, view_errors, cov, cov_ok)).
    """
    model = check_ported(model_name, models=INTRINSICS_MODELS)
    if mesh is not None:
        return _on_mesh(
            intrinsics_batch, mesh, (obj_xy, img_uv, mask), opts=opts, model_name=model_name,
            precision=precision, analytic_jac=analytic_jac, two_phase=bool(two_phase),
        )
    opts = opts or IntrinsicsOptimOptions()
    if mask is None:
        mask = torch.ones(obj_xy.shape[:-1], dtype=torch.bool, device=obj_xy.device)
    seed = intrinsics_linear.estimate_intrinsics(obj_xy, img_uv, mask)
    kmtx = seed.kmtx
    if not opts.optimize_skew:
        kmtx = kmtx.clone()
        kmtx[..., 4] = 0.0  # frozen skew starts at zero
    if two_phase is None:
        two_phase = obj_xy.shape[0] >= TWO_PHASE_MIN_BATCH
    out = _refine(
        obj_xy, img_uv, mask.to(obj_xy.dtype), None, _init_intr(kmtx, model), seed.c_se3_t,
        opts, two_phase, model, precision,
    )
    return seed, out


@profiling.traced("schur")
def intrinsics_facade_batch(
    obj_xy,
    img_uv,
    mask=None,
    view_valid=None,
    opts: Optional[IntrinsicsOptimOptions] = None,
    bounds=None,
    zero_skew: bool = True,
    model_name: str = "pinhole_brown_conrady",
    precision: str = "f64",
    mesh=None,
    analytic_jac: bool | None = None,
    two_phase: bool | None = None,
):
    """Facade-parity fleet solve: the per-camera pipeline of
    PlanarIntrinsicCalibrationFacade (bounds-sanitized Zhang seed,
    frozen-skew zeroing, estimate_planar_pose inits, safe-pose substitution,
    view_valid pose freezing), then the LM refine and covariance, then the
    independent float32 reprojection-RMS QA recheck through the CUDA kernel
    (``reprojection_rms_batch``).

    obj_xy/img_uv: (B, V, N, 2) float64; mask: (B, V, N); view_valid:
    (B, V). two_phase: None -> on for B >= TWO_PHASE_MIN_BATCH. The QA
    recheck runs for a model whose spec has ``qa_recheck`` (pinhole): for
    another model ``rms_check`` is zero and no kernel runs, as in the
    reference.

    Returns (seed, pose_ok (B, V), (LMOutput, intr, poses, view_errors,
    cov, cov_ok), rms_check (B, V) float32). On a mesh each shard runs its
    own QA recheck, one K1 launch per shard on its device.
    """
    model = check_ported(model_name, models=INTRINSICS_MODELS)
    if mesh is not None:
        return _on_mesh(
            intrinsics_facade_batch, mesh, (obj_xy, img_uv, mask, view_valid), opts=opts, bounds=bounds,
            zero_skew=zero_skew, model_name=model_name, precision=precision, analytic_jac=analytic_jac,
            two_phase=bool(two_phase),
        )
    opts = opts or IntrinsicsOptimOptions()
    dtype, device = obj_xy.dtype, obj_xy.device
    b, v = obj_xy.shape[0], obj_xy.shape[1]
    mask = torch.ones(obj_xy.shape[:-1], dtype=dtype, device=device) if mask is None else mask.to(dtype)
    view_valid = torch.ones((b, v), dtype=dtype, device=device) if view_valid is None else view_valid.to(dtype)
    vmask = mask * view_valid[..., None]

    with profiling.span("schur.seed"):
        seed = intrinsics_linear.estimate_intrinsics(obj_xy, img_uv, vmask, bounds=bounds)
        kmtx = seed.kmtx
        if zero_skew:
            kmtx = kmtx.clone()
            kmtx[..., 4] = 0.0
        _, _, _, pose_ok = planarpose.pose_from_homography_pixel(kmtx[:, None, :], seed.homographies)
        init_poses = planarpose.estimate_planar_pose(
            obj_xy, img_uv, kmtx[:, None, :].expand(b, v, 5), vmask
        )
        safe = torch.eye(4, dtype=dtype, device=device)
        safe[2, 3] = 1.0
        good = torch.isfinite(init_poses).all(dim=-1).all(dim=-1) & (view_valid > 0)
        init_poses = torch.where(good[..., None, None], init_poses, safe)

    if two_phase is None:
        two_phase = b >= TWO_PHASE_MIN_BATCH
    out = _refine(
        obj_xy, img_uv, vmask, view_valid, _init_intr(kmtx, model), init_poses, opts, two_phase, model, precision
    )
    if model.qa_recheck:
        rms_check = reprojection_rms_batch(out[2], out[1], obj_xy, img_uv, vmask)
    else:
        rms_check = torch.zeros((b, v), dtype=torch.float32, device=device)
    return seed, pose_ok, out, rms_check


def reprojection_rms_batch(c_se3_t, intrs, obj_xy, img_uv, mask=None):
    """Fleet QA metric: per-view float32 reprojection RMS for B cameras
    (``projection_rms_f32``: one launch of the CUDA kernel in RMS mode on a
    CUDA tensor, reading the caller's tensors in place; its plain version on
    a CPU tensor).

    c_se3_t: (B, V, 4, 4); intrs: (B, 10); obj_xy/img_uv: (B, V, N, 2);
    mask: (B, V, N). Returns (B, V) float32 RMS in pixels.
    """
    if mask is None:
        mask = torch.ones(obj_xy.shape[:3], dtype=torch.float32, device=obj_xy.device)
    with profiling.span("k1.rms"):
        return projection_rms_f32(c_se3_t, intrs, obj_xy, img_uv, mask)


def _extrinsics_phased_solve(opts: ExtrinsicOptions, solver: str, model):
    def solve(iters, obj, uv, mask, intrs, c_se3_r, r_se3_t):
        core = dataclasses.replace(opts.core, compute_covariance=False, max_iterations=iters)
        return optimize_extrinsics_device(
            obj, uv, intrs, c_se3_r, r_se3_t, mask=mask, model=model,
            opts=dataclasses.replace(opts, core=core), solver=solver,
        )

    return solve


def extrinsics_batch(
    obj_xy,
    img_uv,
    init_intrs,
    init_c_se3_r,
    init_r_se3_t,
    mask=None,
    opts: Optional[ExtrinsicOptions] = None,
    model_name: str = "pinhole_brown_conrady",
    mesh=None,
    solver: str = "schur",
    analytic_jac: bool | None = None,
    two_phase: bool | None = None,
):
    """Joint multi-camera extrinsics refinement for a fleet of B rigs (the
    path the stereo benchmark times).

    obj_xy/img_uv: (B, V, C, N, 2); init_intrs: (B, C, pc) for
    ``model_name`` (any registry model); init_c_se3_r: (B, C, 4, 4);
    init_r_se3_t: (B, V, 4, 4); mask: (B, V, C, N). Returns the
    ``optimize_extrinsics_device`` tuple.

    two_phase: run the ``_phase_budget`` of EXTRINSICS_PHASE_CAP and
    EXTRINSICS_PHASE_MID, each phase restarting the unconverged lanes (see
    ``_phased_lm``); None -> on for B >= TWO_PHASE_MIN_BATCH. Covariance
    forces one phase, as in the reference:
    the phase boundaries restart the damping, so a phased solve is a
    different LM path, and the reference computes covariance only on the
    single-phase one. Every model runs the same schedule.
    """
    model = check_ported(model_name, models=EXTRINSICS_MODELS)
    if mesh is not None:
        return _on_mesh(
            extrinsics_batch, mesh, (obj_xy, img_uv, init_intrs, init_c_se3_r, init_r_se3_t, mask), opts=opts,
            model_name=model_name, solver=solver, analytic_jac=analytic_jac, two_phase=bool(two_phase),
        )
    opts = opts or ExtrinsicOptions()
    dtype = obj_xy.dtype
    mask = torch.ones(obj_xy.shape[:-1], dtype=dtype, device=obj_xy.device) if mask is None else mask.to(dtype)
    b, v, c = obj_xy.shape[0], obj_xy.shape[1], obj_xy.shape[2]
    if two_phase is None:
        two_phase = b >= TWO_PHASE_MIN_BATCH
    if not two_phase or opts.core.compute_covariance:
        return optimize_extrinsics_device(
            obj_xy, img_uv, init_intrs, init_c_se3_r, init_r_se3_t, mask=mask, model=model, opts=opts,
            solver=solver,
        )
    lm_m, (intr_m, c_m, r_m) = _phased_lm(
        _extrinsics_phased_solve(opts, solver, model), (obj_xy, img_uv, mask),
        (init_intrs, init_c_se3_r, init_r_se3_t),
        _phase_budget(opts.core.max_iterations, (EXTRINSICS_PHASE_CAP, EXTRINSICS_PHASE_MID)),
        "schur" if solver == "schur" else "dense",
    )
    n_amb = c * model.param_count + 7 * c + 7 * v
    cov = torch.zeros((b, n_amb, n_amb), dtype=dtype, device=obj_xy.device)
    cov_ok = torch.zeros((b,), dtype=torch.bool, device=obj_xy.device)
    return lm_m, intr_m, c_m, r_m, cov, cov_ok


def _homog_seed(obj, uv, mask, seed_precision: str):
    """The DLT seed of ``homography_batch``, in float64 or, opted in,
    float32 (the float64 LM it feeds re-converges to the same minimum)."""
    if seed_precision == "f32":
        f32 = torch.float32
        return H.estimate_homography_dlt(obj.to(f32), uv.to(f32), mask.to(f32)).to(obj.dtype)
    if seed_precision != "f64":
        raise ValueError(f"unknown seed_precision '{seed_precision}' (f64|f32)")
    return H.estimate_homography_dlt(obj, uv, mask)


def _homography_phased_solve(options: OptimOptions):
    def solve(iters, obj, uv, mask, h0):
        op = dataclasses.replace(options, compute_covariance=False, max_iterations=iters)
        return optimize_homography_device(h0, obj, uv, mask, options=op)

    return solve


def homography_batch(
    obj_xy, img_uv, mask=None, options: OptimOptions = OptimOptions(), mesh=None, two_phase: bool | None = None,
    seed_precision: str = "f64",
):
    """DLT seed + LM refine for a batch of homography problems.

    obj_xy/img_uv: (B, N, 2) float64; mask: (B, N). Returns (LMOutput,
    H (B, 3, 3), cov (B, 8, 8), cov_ok (B,)).

    two_phase: every lane up to HOMOG_PHASE_CAP iterations, then the
    unconverged lanes for the rest of the budget (see ``_phased_lm``; the
    budget is never exceeded); covariance is one final pass over the merged
    solution. None -> on for B >= TWO_PHASE_MIN_BATCH.

    seed_precision: "f64" (default) or "f32" for the DLT seed (the
    reference's default is f32; its seed is equivalence-tested only on
    well-conditioned data).
    """
    if mesh is not None:
        return _on_mesh(
            homography_batch, mesh, (obj_xy, img_uv, mask), options=options, two_phase=bool(two_phase),
            seed_precision=seed_precision,
        )
    dtype = obj_xy.dtype
    mask = torch.ones(obj_xy.shape[:-1], dtype=dtype, device=obj_xy.device) if mask is None else mask.to(dtype)
    init_h = _homog_seed(obj_xy, img_uv, mask, seed_precision)
    b = obj_xy.shape[0]
    if two_phase is None:
        two_phase = b >= TWO_PHASE_MIN_BATCH
    if not two_phase:
        return optimize_homography_device(init_h, obj_xy, img_uv, mask, options=options)
    lm_m, (h_m,) = _phased_lm(
        _homography_phased_solve(options), (obj_xy, img_uv, mask), (init_h,),
        _phase_budget(options.max_iterations, (HOMOG_PHASE_CAP,)), "dense",
    )
    if options.compute_covariance:
        cov, cov_ok = homography_covariance_device(h_m, obj_xy, img_uv, mask, options)
    else:
        cov = torch.zeros((b, 8, 8), dtype=dtype, device=obj_xy.device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=obj_xy.device)
    return lm_m, h_m, cov, cov_ok


def handeye_batch(
    base_se3_gripper, cam_se3_target, options: OptimOptions = OptimOptions(), min_angle_deg: float = 1.0,
    mesh=None, rot_residual: str = "quat",
):
    """Tsai-Lenz DLT seed + AX = XB LM for a batch of rigs: one pair build
    feeds both. base_se3_gripper/cam_se3_target: (B, P, 4, 4).
    rot_residual: "quat" (default) or "log" (see optimize_handeye_device).
    Returns the optimize_handeye_device tuple."""
    if mesh is not None:
        return _on_mesh(
            handeye_batch, mesh, (base_se3_gripper, cam_se3_target), options=options, min_angle_deg=min_angle_deg,
            rot_residual=rot_residual,
        )
    pairs = handeye_linear.build_all_pairs(base_se3_gripper, cam_se3_target, min_angle_deg)
    init, _ = handeye_linear.estimate_handeye_dlt_pairs(pairs)
    return optimize_handeye_device(pairs, init, options, rot_residual=rot_residual)


def planar_pose_batch(obj_xy, img_uv, kmtx, mask=None, options: OptimOptions = OptimOptions(), mesh=None):
    """VarPro planar pose for a batch: the planar-pose DLT seed under K,
    then ``optimize_planar_pose_device`` with two radial coefficients.
    obj_xy/img_uv: (B, N, 2); kmtx: (B, 5); mask: optional (B, N). Returns
    its tuple."""
    if mesh is not None:
        return _on_mesh(planar_pose_batch, mesh, (obj_xy, img_uv, kmtx, mask), options=options)
    if mask is None:
        mask = torch.ones(obj_xy.shape[:-1], dtype=torch.bool, device=obj_xy.device)
    init = planarpose.estimate_planar_pose(obj_xy, img_uv, kmtx, mask)
    return optimize_planar_pose_device(init, obj_xy, img_uv, kmtx, num_radial=2, mask=mask, options=options)


def _bundle_phased_solve(opts: BundleOptions, analytic_jac: bool):
    def solve(iters, obj, uv, bg, cam_idx, mask, intrs, g0, b0):
        core = dataclasses.replace(opts.core, compute_covariance=False, max_iterations=iters)
        return optimize_bundle_device(
            obj, uv, bg, cam_idx, intrs, g0, b0, mask=mask, opts=dataclasses.replace(opts, core=core),
            analytic_jac=analytic_jac,
        )

    return solve


@profiling.traced("dense")
def bundle_batch(
    obj_xy, img_uv, b_se3_g, cam_idx, init_intrs, init_g_se3_c, init_b_se3_t,
    mask=None, opts: Optional[BundleOptions] = None, mesh=None,
    analytic_jac: bool | None = None, two_phase: bool | None = None,
):
    """Bundle adjustment for a batch of B rigs (a leading B axis on every
    argument; see ``optimize_bundle_device``). Returns its tuple.

    analytic_jac: None or True -> the analytic pinhole Jacobian, False ->
    forward-mode autodiff. two_phase: every lane up to BUNDLE_PHASE_CAP
    iterations, then the unconverged lanes for the rest of the budget (see
    ``_phased_lm``; the budget is never exceeded); None -> on for B >=
    TWO_PHASE_MIN_BATCH. Covariance forces one phase, as in the reference.
    """
    if mesh is not None:
        return _on_mesh(
            bundle_batch, mesh, (obj_xy, img_uv, b_se3_g, cam_idx, init_intrs, init_g_se3_c, init_b_se3_t, mask),
            opts=opts, analytic_jac=analytic_jac, two_phase=bool(two_phase),
        )
    opts = opts or BundleOptions()
    analytic = True if analytic_jac is None else bool(analytic_jac)
    dtype = obj_xy.dtype
    mask = torch.ones(obj_xy.shape[:-1], dtype=dtype, device=obj_xy.device) if mask is None else mask.to(dtype)
    b = obj_xy.shape[0]
    if two_phase is None:
        two_phase = b >= TWO_PHASE_MIN_BATCH
    if not two_phase or opts.core.compute_covariance:
        return optimize_bundle_device(
            obj_xy, img_uv, b_se3_g, cam_idx, init_intrs, init_g_se3_c, init_b_se3_t, mask=mask, opts=opts,
            analytic_jac=analytic,
        )
    lm_m, (intr_m, g_m, b_m) = _phased_lm(
        _bundle_phased_solve(opts, analytic), (obj_xy, img_uv, b_se3_g, cam_idx, mask),
        (init_intrs, init_g_se3_c, init_b_se3_t),
        _phase_budget(opts.core.max_iterations, (BUNDLE_PHASE_CAP,)), "dense",
    )
    c = init_intrs.shape[1]
    n_amb = c * PINHOLE.param_count + 7 * c + 7
    cov = torch.zeros((b, n_amb, n_amb), dtype=dtype, device=obj_xy.device)
    cov_ok = torch.zeros((b,), dtype=torch.bool, device=obj_xy.device)
    return lm_m, intr_m, g_m, b_m, cov, cov_ok


# the camera models the line-scan paths take: every registry model (the
# lift needs only its ``unproject_normalized``)
LINESCAN_MODELS = tuple(m.name for m in SPECS)


def _linescan_points(camera, obj_xy, target_uv, laser_uv, target_mask, laser_mask, model_name):
    """The lifted laser points of a batch of rigs: every target and laser
    pixel unprojected through the camera model (distortion, and sensor tilt
    for Scheimpflug), then ``lift_laser_points``. Returns (points
    (B, V*L, 3), point mask (B, V*L), views_ok (B,))."""
    model = check_ported(model_name, models=LINESCAN_MODELS)
    cam = camera[:, None, None, :]
    return ls.lift_laser_points(
        obj_xy, model.unproject_normalized(cam, target_uv), model.unproject_normalized(cam, laser_uv),
        target_mask=target_mask, laser_mask=laser_mask,
    )


def linescan_batch(camera, obj_xy, target_uv, laser_uv, target_mask=None,
                   laser_mask=None, mesh=None, model_name: str = "pinhole_brown_conrady"):
    """Laser-plane calibration for a batch of line-scan rigs (SVD plane
    fit).

    camera: (B, pc) flat intrinsics for ``model_name`` (10 for pinhole, 12
    for Scheimpflug); obj_xy/target_uv: (B, V, N, 2) target detections;
    laser_uv: (B, V, L, 2) laser pixels; masks optional (B, V, N) and
    (B, V, L). Returns a LineScanResult batch (plane (B, 4), covariance
    (B, 4, 4) zero, homography (B, 3, 3), rms_error (B,), inlier_count
    (B,), ok (B,)).
    """
    if mesh is not None:
        return _on_mesh(
            linescan_batch, mesh, (camera, obj_xy, target_uv, laser_uv, target_mask, laser_mask),
            model_name=model_name,
        )
    return ls.fit_laser_plane(
        *_linescan_points(camera, obj_xy, target_uv, laser_uv, target_mask, laser_mask, model_name)
    )


def linescan_ransac_batch(
    camera, obj_xy, target_uv, laser_uv, target_mask=None, laser_mask=None,
    options=None, mesh=None,
    model_name: str = "pinhole_brown_conrady",
):
    """Laser-plane calibration with the RANSAC plane fit for a batch of
    rigs, the outlier-robust variant of ``linescan_batch``: every rig is a
    lane of ``ransac_plane`` over its (V*L, 3) lifted laser points, 3-point
    hypotheses scored by plane distance, the inliers refit by SVD.

    Arguments as ``linescan_batch`` plus RANSAC ``options`` (default
    ``RansacOptions(thresh=0.005, min_inliers=12)``; thresh is in metres,
    a plane-point distance). Returns a LineScanResult batch.
    """
    if mesh is not None:
        return _on_mesh(
            linescan_ransac_batch, mesh, (camera, obj_xy, target_uv, laser_uv, target_mask, laser_mask),
            options=options, model_name=model_name,
        )
    options = options or RansacOptions(thresh=0.005, min_inliers=12)
    pts, pts_mask, _ = _linescan_points(camera, obj_xy, target_uv, laser_uv, target_mask, laser_mask, model_name)
    rr = ransac_plane(pts, options, mask=pts_mask)
    return ls.LineScanResult(
        plane=rr.model,
        covariance=pts.new_zeros(pts.shape[:1] + (4, 4)),
        homography=ls.build_plane_homography(rr.model),
        rms_error=planefit.plane_rms(rr.model, pts, rr.inlier_mask),
        inlier_count=rr.inlier_count,
        ok=rr.success & (pts_mask.sum(dim=-1) >= 3),
    )
