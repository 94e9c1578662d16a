"""Fleet dispatch for the extrinsics stages (port of the extrinsics part of
``calibration_tpu/pipeline/fleet.py``; the hand-eye and bundle fleets come
with their slices).

The reference runs every stereo pair and rig serially. Here jobs are
bucketed by shape and options, each bucket runs as ONE batched seed + LM
on the given device, its results come back to the host in one transfer,
and they return in submission order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..convert import to_numpy
from ..models import camera_matrix as cm
from ..ops import extrinsics_linear
from ..optim.core import OptimResult, TerminationType, brief_report
from ..optim.extrinsics import ExtrinsicOptimizationResult, optimize_extrinsics_device


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
