"""Fleet dispatch for the extrinsics, hand-eye and bundle stages (port of
``calibration_tpu/pipeline/fleet.py``).

The reference runs every stereo pair, rig and sensor serially. Here jobs
are bucketed by shape and options, each bucket runs as ONE batched solve
on the given device, its results come back to the host in one transfer,
and they return in submission order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..convert import to_numpy
from ..models import camera_matrix as cm
from ..ops import extrinsics_linear, planarpose, se3
from ..ops import handeye_linear as hel
from ..optim.bundle import BundleResult, bundle_result, optimize_bundle_device
from ..optim.core import OptimOptions, OptimResult, TerminationType, brief_report
from ..optim.extrinsics import ExtrinsicOptimizationResult, optimize_extrinsics_device
from ..optim.handeye import HandeyeResult, _wrap_result, estimate_and_optimize_handeye_device
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class ExtrinsicsJob:
    """One rig's or pair's extrinsics problem (stereo pairs are the C = 2
    case)."""

    obj: np.ndarray  # (V, C, N, 2)
    uv: np.ndarray  # (V, C, N, 2)
    mask: np.ndarray  # (V, C, N) bool
    cameras: np.ndarray  # (C, pc)
    opts: object  # ExtrinsicOptions (frozen dataclass)


def _seed_and_optimize(obj, uv, mask, cameras, opts):
    """The one DLT-seed + joint-LM recipe, batched over rigs: normalize
    with each camera's K, ``estimate_extrinsic_dlt``, then
    ``optimize_extrinsics_device`` (one phase). obj/uv: (B, V, C, N, 2);
    mask: (B, V, C, N) bool; cameras: (B, C, pc). Returns (ExtrinsicPoses,
    the optimize_extrinsics_device tuple)."""
    norm_uv = cm.normalize(cameras[:, None, :, None, :5], uv)
    init = extrinsics_linear.estimate_extrinsic_dlt(obj, norm_uv, mask)
    out = optimize_extrinsics_device(
        obj, uv, cameras, init.c_se3_r, init.r_se3_t, mask=mask.to(obj.dtype), opts=opts
    )
    return init, out


def extrinsics_fleet(jobs: Sequence[ExtrinsicsJob], device) -> List:
    """Batched DLT-seed + joint-LM extrinsics on ``device``: one batched
    solve per (V, C, N, pc, opts) bucket. Returns per job, in order:
    ((initial c_se3_r, initial r_se3_t) numpy, ExtrinsicOptimizationResult)."""
    buckets: Dict[tuple, List[int]] = {}
    for idx, job in enumerate(jobs):
        buckets.setdefault((job.obj.shape, job.cameras.shape, job.opts), []).append(idx)

    out: List = [None] * len(jobs)
    for (_, _, opts), idxs in buckets.items():
        def stack(field, dtype=torch.float64):
            return torch.as_tensor(np.stack([getattr(jobs[i], field) for i in idxs]), dtype=dtype, device=device)

        init, lm_res = _seed_and_optimize(
            stack("obj"), stack("uv"), stack("mask", torch.bool), stack("cameras"), opts
        )
        # one transfer per bucket; per-job slices are then host-side
        init, (lm_out, intr, c_se3_r, r_se3_t, cov, cov_ok) = to_numpy((init, lm_res))
        for j, i in enumerate(idxs):
            core = OptimResult(
                success=bool(lm_out.success[j]),
                covariance=cov[j] if (opts.core.compute_covariance and bool(cov_ok[j])) else None,
                final_cost=float(lm_out.cost[j]),
                iterations=int(lm_out.iterations[j]),
                termination=TerminationType(int(lm_out.termination[j])),
                initial_cost=float(lm_out.initial_cost[j]),
            )
            core.report = brief_report(core)
            opt = ExtrinsicOptimizationResult(
                core=core, cameras=intr[j], c_se3_r=c_se3_r[j], r_se3_t=r_se3_t[j]
            )
            out[i] = ((init.c_se3_r[j], init.r_se3_t[j]), opt)
    return out


def _tensor(a, device, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def planar_pose_fleet(jobs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], device) -> List[np.ndarray]:
    """Linear planar poses for many views on ``device``, one batched call
    per point count. jobs: (obj (N, 2), uv (N, 2), kmtx (5,)). Returns the
    (4, 4) poses in job order."""
    buckets: Dict[int, List[int]] = {}
    for idx, (obj, _, _) in enumerate(jobs):
        buckets.setdefault(obj.shape[0], []).append(idx)

    out: List[np.ndarray] = [None] * len(jobs)  # type: ignore[list-item]
    for _, idxs in sorted(buckets.items()):
        obj, uv, kmtx = (_tensor(np.stack([jobs[i][k] for i in idxs]), device) for k in range(3))
        mask = torch.ones(obj.shape[:-1], dtype=torch.bool, device=device)
        poses = to_numpy(planarpose.estimate_planar_pose(obj, uv, kmtx, mask))
        for j, i in enumerate(idxs):
            out[i] = poses[j]
    return out


def _handeye_results(device_out, idxs, opts, out) -> None:
    """One transfer for a bucket, then one HandeyeResult per job."""
    lm_out, pose, cov, cov_ok = to_numpy(device_out)
    for j, i in enumerate(idxs):
        out[i] = _wrap_result(type(lm_out)(*(a[j] for a in lm_out)), pose[j], cov[j], cov_ok[j], opts)


def handeye_fleet(
    jobs: Sequence[Tuple[np.ndarray, np.ndarray, float, OptimOptions]], device
) -> List[HandeyeResult]:
    """Batched ``estimate_and_optimize_handeye`` on ``device``. jobs:
    (base_se3_gripper (P, 4, 4), cam_se3_target (P, 4, 4), min_angle_deg,
    options), bucketed by (P, min_angle_deg, options). Returns a
    HandeyeResult per job, in order."""
    buckets: Dict[tuple, List[int]] = {}
    for idx, (bg, _, ang, opts) in enumerate(jobs):
        buckets.setdefault((bg.shape[0], float(ang), opts), []).append(idx)

    out: List[HandeyeResult] = [None] * len(jobs)  # type: ignore[list-item]
    for (_, ang, opts), idxs in buckets.items():
        bg = _tensor(np.stack([jobs[i][0] for i in idxs]), device)
        ct = _tensor(np.stack([jobs[i][1] for i in idxs]), device)
        _handeye_results(estimate_and_optimize_handeye_device(bg, ct, ang, opts), idxs, opts, out)
    return out


@profiling.traced("dense")
def planar_handeye_fleet(
    jobs: Sequence[Tuple[List[np.ndarray], List[np.ndarray], np.ndarray, np.ndarray, float, OptimOptions]],
    device,
) -> List[HandeyeResult]:
    """Per-view planar poses + ``estimate_and_optimize_handeye`` in one
    batched solve per bucket on ``device``; the camera -> target poses stay
    on the device. jobs: (obj_list [O x (N_i, 2)], uv_list, kmtx (5,),
    base_se3_gripper (O, 4, 4), min_angle_deg, options). Views are padded
    to the bucket's largest point count with masks (masked rows are zeroed,
    exactly equivalent to dropping them in the pose least squares).
    Bucketed by (O, padded N, min_angle_deg, options). Returns a
    HandeyeResult per job, in order: the results of planar_pose_fleet +
    handeye_fleet."""
    buckets: Dict[tuple, List[int]] = {}
    for idx, (objs, _, _, _, ang, opts) in enumerate(jobs):
        nmax = max(o.shape[0] for o in objs)
        buckets.setdefault((len(objs), nmax, float(ang), opts), []).append(idx)

    out: List[HandeyeResult] = [None] * len(jobs)  # type: ignore[list-item]
    for (o_count, nmax, ang, opts), idxs in buckets.items():
        r = len(idxs)
        obj = np.zeros((r, o_count, nmax, 2))
        uv = np.zeros((r, o_count, nmax, 2))
        mask = np.zeros((r, o_count, nmax), bool)
        for j, i in enumerate(idxs):
            for k, (ob, im) in enumerate(zip(jobs[i][0], jobs[i][1])):
                n = ob.shape[0]
                obj[j, k, :n] = ob
                uv[j, k, :n] = im
                mask[j, k, :n] = True
        kmtx = _tensor(np.stack([jobs[i][2] for i in idxs]), device)
        bg = _tensor(np.stack([jobs[i][3] for i in idxs]), device)
        ct = planarpose.estimate_planar_pose(
            _tensor(obj, device), _tensor(uv, device), kmtx[:, None, :].expand(r, o_count, 5),
            _tensor(mask, device, torch.bool),
        )
        _handeye_results(estimate_and_optimize_handeye_device(bg, ct, ang, opts), idxs, opts, out)
    return out


def handeye_dlt_fleet(jobs: Sequence[Tuple[np.ndarray, np.ndarray, float]], device) -> List[Tuple[np.ndarray, bool]]:
    """Batched Tsai-Lenz DLT seeds (no LM) on ``device``: the bundle stage's
    hand-eye initialization when no hand-eye result exists. jobs:
    (base_se3_gripper (P, 4, 4), cam_se3_target (P, 4, 4), min_angle_deg),
    bucketed by (P, min_angle_deg). Returns (pose (4, 4), ok) per job, in
    order."""
    buckets: Dict[tuple, List[int]] = {}
    for idx, (bg, _, ang) in enumerate(jobs):
        buckets.setdefault((bg.shape[0], float(ang)), []).append(idx)

    out: List = [None] * len(jobs)
    for (_, ang), idxs in buckets.items():
        bg = _tensor(np.stack([jobs[i][0] for i in idxs]), device)
        ct = _tensor(np.stack([jobs[i][1] for i in idxs]), device)
        poses, oks = to_numpy(hel.estimate_handeye_dlt(bg, ct, ang))
        for j, i in enumerate(idxs):
            out[i] = (poses[j], bool(oks[j]))
    return out


def average_isometries_fleet(groups: Sequence[Sequence[np.ndarray]], device) -> List[np.ndarray]:
    """Quaternion averages of many pose groups in one batched call on
    ``device``, each group padded to the longest with masked identities.
    Returns one (4, 4) pose per group, in order."""
    if not groups:
        return []
    kmax = max(len(g) for g in groups)
    poses = np.tile(np.eye(4), (len(groups), kmax, 1, 1))
    mask = np.zeros((len(groups), kmax))
    for i, g in enumerate(groups):
        for k, p in enumerate(g):
            poses[i, k] = p
            mask[i, k] = 1.0
    avg = to_numpy(se3.average_isometries(_tensor(poses, device), _tensor(mask, device)))
    return list(avg)


@dataclasses.dataclass(frozen=True)
class BundleJob:
    """One rig's bundle problem (the optimize_bundle argument set)."""

    obj: np.ndarray  # (O, N, 2)
    uv: np.ndarray  # (O, N, 2)
    bg: np.ndarray  # (O, 4, 4)
    cam_idx: np.ndarray  # (O,)
    cameras: np.ndarray  # (C, pc)
    he_init: np.ndarray  # (C, 4, 4)
    target: np.ndarray  # (4, 4)
    mask: np.ndarray  # (O, N)
    opts: object  # BundleOptions (frozen dataclass)


@dataclasses.dataclass(frozen=True)
class FusedBundleJob:
    """One rig's whole bundle-stage device work when every hand-eye init is
    known on the host (source "handeye" or "identity", no DLT seed): planar
    poses, the averaged-target init and the bundle LM in one batched
    solve."""

    obj: np.ndarray  # (O, N, 2)
    uv: np.ndarray  # (O, N, 2)
    mask: np.ndarray  # (O, N)
    kmtx: np.ndarray  # (O, 5): each observation's camera K
    bg: np.ndarray  # (O, 4, 4)
    cam_idx: np.ndarray  # (O,)
    cameras: np.ndarray  # (C, pc)
    he_init: np.ndarray  # (C, 4, 4)
    target_given: np.ndarray  # (4, 4), used when use_given_target
    use_given_target: bool
    opts: object  # BundleOptions (frozen dataclass)


def _bundle_buckets(jobs):
    buckets: Dict[tuple, List[int]] = {}
    for idx, job in enumerate(jobs):
        buckets.setdefault((job.obj.shape, job.cameras.shape, job.opts), []).append(idx)
    return buckets


def _stacker(jobs, idxs, device):
    def stack(field, dtype=torch.float64):
        return torch.as_tensor(np.stack([np.asarray(getattr(jobs[i], field)) for i in idxs]), dtype=dtype,
                               device=device)

    return stack


def _bundle_results(host, opts) -> List[BundleResult]:
    """One BundleResult per lane of a bucket's ``optimize_bundle_device``
    tuple, brought to the host in one transfer."""
    lm_out, *rest = host
    return [
        bundle_result(type(lm_out)(*(a[j] for a in lm_out)), *(a[j] for a in rest), opts)
        for j in range(lm_out.cost.shape[0])
    ]


def bundle_fleet(jobs: Sequence[BundleJob], device) -> List[BundleResult]:
    """Batched ``optimize_bundle`` on ``device``: one batched solve per
    (O, N, C, pc, opts) bucket. Returns a BundleResult per job, in
    order."""
    out: List = [None] * len(jobs)
    for (_, _, opts), idxs in _bundle_buckets(jobs).items():
        stack = _stacker(jobs, idxs, device)
        lm_res = optimize_bundle_device(
            stack("obj"), stack("uv"), stack("bg"), stack("cam_idx", torch.long), stack("cameras"),
            stack("he_init"), stack("target"), mask=stack("mask"), opts=opts,
        )
        # one transfer per bucket; per-job slices are then host-side
        for i, res in zip(idxs, _bundle_results(to_numpy(lm_res), opts)):
            out[i] = res
    return out


def _averaged_target(ct, bg, cam_idx, g0):
    """The averaged target init b_se3_g X c_se3_t over a rig's
    observations (bundle_utils.cpp:202-237): ct/bg (R, O, 4, 4), cam_idx
    (R, O), g0 (R, C, 4, 4). The candidates are taken in sensor-major order
    (a stable sort by cam_idx), the staged path's order, on which the
    quaternion sign alignment depends."""
    order = torch.sort(cam_idx, dim=-1, stable=True).indices
    x_per_obs = torch.gather(g0, 1, cam_idx[..., None, None].expand(cam_idx.shape + (4, 4)))
    cand = torch.gather(bg @ x_per_obs @ ct, 1, order[..., None, None].expand(order.shape + (4, 4)))
    return se3.average_isometries(cand, torch.ones(cand.shape[:2], dtype=cand.dtype, device=cand.device))


@profiling.traced("dense")
def bundle_fused_fleet(jobs: Sequence[FusedBundleJob], device) -> List[Tuple[BundleResult, np.ndarray]]:
    """The bundle stage's device work in one batched solve per
    (O, N, C, pc, opts) bucket on ``device``: planar poses, the averaged
    target init (or the given one), then the bundle LM. Returns
    (BundleResult, target init (4, 4)) per job, in order."""
    out: List = [None] * len(jobs)
    for (_, _, opts), idxs in _bundle_buckets(jobs).items():
        stack = _stacker(jobs, idxs, device)
        obj, uv, mask, bg = stack("obj"), stack("uv"), stack("mask"), stack("bg")
        cam_idx, g0 = stack("cam_idx", torch.long), stack("he_init")
        ct = planarpose.estimate_planar_pose(obj, uv, stack("kmtx"), mask > 0)
        use_given = stack("use_given_target", torch.bool)
        tgt0 = torch.where(use_given[:, None, None], stack("target_given"), _averaged_target(ct, bg, cam_idx, g0))
        lm_res = optimize_bundle_device(obj, uv, bg, cam_idx, stack("cameras"), g0, tgt0, mask=mask, opts=opts)
        host, tgt0 = to_numpy((lm_res, tgt0))  # one transfer per bucket
        for j, (i, res) in enumerate(zip(idxs, _bundle_results(host, opts))):
            out[i] = (res, tgt0[j])
    return out
