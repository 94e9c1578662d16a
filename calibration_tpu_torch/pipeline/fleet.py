"""Fleet dispatch for the extrinsics and hand-eye stages (port of those
parts of ``calibration_tpu/pipeline/fleet.py``; the bundle fleets come with
their slice).

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
from ..ops import extrinsics_linear, planarpose
from ..optim.core import OptimOptions, OptimResult, TerminationType, brief_report
from ..optim.extrinsics import ExtrinsicOptimizationResult, optimize_extrinsics_device
from ..optim.handeye import HandeyeResult, _wrap_result, estimate_and_optimize_handeye_device


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
