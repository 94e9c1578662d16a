#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the
   card's name and power limit.
2. Builds the CUDA kernels of ``calibration_tpu_torch/csrc`` with nvcc and,
   beside that build, prints ptxas's registers and spills for K1.
3. Holds both modes of K1 (``projection_residuals_f32``, residual mode;
   ``projection_rms_f32``, the fused QA recheck) against their plain
   versions on the card, from float32 (bool and float32 masks) and float64
   inputs, at the shapes the facade (2560 x 88), the pipeline's
   intrinsics stage (1280 x 88) and a shard of the 4-shard mesh (640 x 88)
   give it and at a ragged one, each with an
   all-masked view: within KERNEL_ATOL_PX of plain float64, the RMS within
   RMS_RTOL_F32 of plain float32, masked residuals exactly 0.
4. Drives the main path once: ``intrinsics_facade_batch`` on the bench.py
   problem set (B = 256 cameras, 10 views of an 8x11 grid, noise 0.2 px,
   seed 7, max_iterations 40, epsilon 1e-9, covariance on), checks the
   result and that its QA recheck was one K1 launch in RMS mode, then
   times a second call. The public residual op then runs once on the
   solved fleet; the RMS of its residuals must be the QA recheck's.
5. Solves the first 8 problems again on the CPU and holds the final costs
   against the card's within 1e-7 relative.
6. Drives the planar_intrinsics app (``--fleet --device cuda``) on the same
   problem set written as 256 detections files, with 4 of the 88 points of
   every view displaced by 20-40 px and the RANSAC prefilter on: a first and
   a warm call, each timed by layer (ingest, prefilter, solve, QA kernel,
   report writing). It checks the reports (every displaced point rejected
   and every clean point kept, every camera converged, mean RMS in
   [0.15, 0.25] px, no QA warning), that K1 (RMS mode) and the prefilter
   ran on the card, and card/CPU parity of the app on the first 8 sensors.
7. Solves the stereo benchmark set (BASELINE config 3: B = 128 two-camera
   rigs, 8 views of a 5x7 grid at 0.05 m, noise 0.2 px, seed 13,
   max_iterations 50, covariance off, so the phased schedule runs) through
   ``extrinsics_batch`` on the card: every lane converged, camera 1's pose
   within POSE_TOL_M / POSE_TOL_DEG of the truth, card vs CPU final cost
   within 1e-7 relative on the first 8 rigs (same schedule), and a warm
   call timed in rigs/s.
8. Drives the intrinsic_extrinsic_pipeline app (``--device cuda``) on 64
   stereo rigs written as 128 detections files (10 views x 88 points, 0.2
   px noise), with 64 stereo pairs and 64 two-camera multicam rigs: a first
   and a warm call, each timed by layer (ingest, intrinsics stage, stereo
   stage, multicam, writing). It checks exit 0, every pair ``ok``, every
   rig converged, camera 1's pose within the pose bound for every pair and
   rig, that the intrinsics stage launched K1 in RMS mode and that its QA
   recheck agrees with the f64 view errors on every camera, and card/CPU parity
   of the artifacts on the first 4 rigs (``tests/torch_helpers``' report
   bounds).
9. Solves the homography benchmark set (BASELINE config 1: B = 8192, 24
   points, 0.1 px noise, seed 11, max_iterations 50, covariance off, the
   float64 DLT seed, phased) through ``homography_batch`` on the card:
   every lane converged, the mean residual RMS in HOMOG_RMS_PX, card vs CPU
   transfer cost within 1e-7 relative on 32 lanes, first and warm call in
   solves/s.
10. Solves the hand-eye benchmark set (BASELINE config 4: B = 256 rigs, 20
   noise-free robot poses, seed 17, max_iterations 50, covariance off)
   through ``handeye_batch`` on the card: every rig converged, X within
   1e-7 m / 1e-5 deg of the truth, card vs CPU on 16 rigs (X within 1e-9,
   the same counters), warm rigs/s.
11. Solves the bundle benchmark set (BASELINE config 5: B = 128 rigs, 20
   observations of an 8x11 grid at 0.03 m, 0.2 px noise, seed 19,
   max_iterations 50, covariance off, intrinsics fixed at the truth, the
   perturbed g0 and b0 seeds) through ``bundle_batch`` on the card: every
   rig converged, g_se3_c within BUNDLE_TOL of the truth, the linearization
   histogram, the first call and the median of WARM_CALLS warm calls
   in rigs/s, card vs CPU on 8 rigs (cost within 1e-7 relative, the same
   iterations and termination).
12. Drives the four-stage bundle_pipeline app (``--device cuda``:
   intrinsics, hand-eye, bundle) on 64 robot cells of the JAX package's
   pipeline fleet with its bundle section (12 observations of an 8x11
   grid, 0.05 px noise, seed 29; ``write_handeye_fleet``): first and warm
   call timed by layer (ingest, intrinsics, hand_eye, bundle, writing);
   every hand-eye and bundle rig ``ok``, every bundle hand-eye init from
   the hand-eye stage (the fused path), hand-eye g_se3_c within
   HE_POSE_TOL and bundle g_se3_c within BUNDLE_PIPE_TOL of the truth, K1
   launched with no QA warning; card/CPU artifacts on 4 rigs within the
   report bounds with the bundle section, without it, and with DLT seeds
   (the staged path); then the homography app on the card (DLT and RANSAC
   input) against the CPU app.
13. Solves row 5L (the JAX package's line-scan set: B = 1024 rigs, 6
   views of a 5x7 grid at 0.03 m, 40 laser pixels, 0.1 px, seed 23)
   through ``linescan_batch`` on the card: every rig ``ok``, the plane
   normal within LINESCAN_TOL_DEG of the truth, the first call and the
   median of WARM_CALLS warm calls in rigs/s, card vs CPU planes within
   1e-9 on 32 rigs.
14. Rows 5R and 5S (B = 256, 20% of the laser pixels replaced by junk,
   seeds 31 and 37; 5S through the Scheimpflug camera, tau = (0.06,
   -0.04)) through ``linescan_ransac_batch`` (256 hypotheses, 4 mm): the
   same checks, RANSAC rounds on the card, card vs CPU on 8 rigs with the
   same inlier counts (both draw their noise on the CPU); for 5S also the
   rate relative to the same set through the pinhole camera.
15. Rows 2S and 2T (the bench.py set through a tilted sensor, tau =
   (0.05, -0.04) with covariance, and (0.09, -0.07) without; p1, p2
   pinned at 0) through ``intrinsics_batch`` with the Scheimpflug model
   on the card (phased, forward-mode Jacobians): every lane converged,
   bench_all.py's tilt gates (median < 0.006, p95 < 0.015, max < 0.03
   rad), the mean view RMS at the 0.2 px noise, covariance finite (2S),
   the linearization histogram, first call and warm median, card vs CPU
   on 8 lanes (cost within 1e-7 relative, the same iterations and
   termination).
16. Drives the linescan_calibration app (``--device cuda``) on the
   committed example, a RANSAC variant of it and a Scheimpflug input:
   exit 0 and the CPU app's artifact within the report bounds. No new
   phase launches K1 (checked).
17. VarPro planar pose on every view of the bench.py set (2560 problems,
   K at the truth, k3 = 0) through ``planar_pose_batch``: every lane
   converged, each pose within PLANAR_TOL of the truth, the mean RMS at
   the noise, covariance finite; first call and warm median; card vs CPU
   on 32 lanes (cost within 1e-7 relative, the same linearizations and
   success: the trials at the minimum are roundoff's, see
   PLANAR_PARITY_COUNTERS).
18. Semi-DLT on the bench.py set's 256 cameras (the Zhang seed's K)
   through ``optimize_intrinsics_semidlt_device``: every camera
   converged, K and k1, k2 within SEMIDLT_TOL of the truth, the RMS at
   the noise, covariance finite; card vs CPU on 8 cameras (cost, the same
   iterations and termination).
19. Config 3's stereo set through the Scheimpflug camera (tau = (0.06,
   -0.04), p1 = p2 = 0) via ``extrinsics_batch(model_name=...)``, the
   cameras fixed: every rig converged, camera 1 within POSE_TOL; card vs
   CPU on 8 rigs.
20. Config 5's set through the same camera via
   ``optimize_bundle_device(model=SCHEIMPFLUG)``, the intrinsics fixed:
   every rig converged, g_se3_c within BUNDLE_TOL; card vs CPU on 8 rigs.
   None of 17-20 launches K1 (checked).
21. The ``mesh`` argument: config 2 through ``intrinsics_facade_batch``
   on a mesh of every visible card (B = 256) and on 4 shards of one card
   (B = 254, padded to 256), config 5 through ``bundle_batch`` (B = 126)
   and planar pose (2558 views) on the 4-shard mesh: every lane
   converged, the unpadded outputs on the mesh's first device, K1
   launched once per shard on the facade calls and its gathered RMS
   within RMS_RTOL_F32 of plain float32 on the gathered solution, final
   cost within 1e-10
   relative of the unsharded single-phase call on the same inputs with
   the same counters (planar pose: linearizations and success), warm
   medians of both (MESH_WARM_CALLS on the 4-shard cells, whose shards
   run in turn on one thread). With one card visible, multi-card scaling is
   reported as not measured.
22. The precisions: config 2 (B = 256, phased) through ``intrinsics_batch``
   in "f64", "mixed" and "mixed_jac", config 5 (B = 128) through
   ``optimize_bundle_device`` in "f64" and "mixed": every lane converged,
   each lane's final cost within 1e-7 relative of the f64 run's, the
   cells' truth bounds; interleaved warm medians.
23. ``lm_cost_trace`` on config 1 (B = 8192, single phase): its output
   equal to ``lm_core``'s, the last linearization's cost the final cost,
   no curve rising, the median curve, its time against ``lm_core``'s; then
   one warm config-2 facade call under ``device_trace``, whose Chrome
   trace names K1's kernel.
24. Times each mode of K1 on its own, at 2560 x 88 and 1280 x 88: device
   time of the bare launcher captured in a CUDA graph (L2-warm on one input
   set, L2-cold over rotating sets), the kernel's duration as
   torch.profiler reads it, the wrapper's host time per call, the bound and
   its share, the plain version's device time, and the old unfused QA pass
   (float32 copies, residual mode, the RMS in PyTorch) beside the RMS mode;
   and checks with torch.profiler that ``reprojection_rms_batch`` runs one
   device kernel, K1. This comes last: the profiler's tracing would slow
   the end-to-end phases' launches.

Earlier lines report each phase. Then come the kernels JSON record (one
entry per K1 mode: launches on the driven paths, the worst error against
plain f64, and at 2560 x 88 the device time ``ms`` (L2-cold) and
``ms_warm``, the profiler's ``kernel_ms``, the wrapper's ``host_ms``,
``plain_ms``, ``bound_ms``), the card's name and power limit, and last the
device JSON record. Any failed check exits non-zero. The script imports
nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from calibration_tpu_torch import native
from calibration_tpu_torch.apps import bundle_pipeline, homography as homography_app
from calibration_tpu_torch.apps import intrinsic_extrinsic_pipeline, linescan_calibration, planar_intrinsics
from calibration_tpu_torch.kernels import _build
from calibration_tpu_torch.models import pinhole, scheimpflug
from calibration_tpu_torch.models.registry import SCHEIMPFLUG
from calibration_tpu_torch.ops import intrinsics_linear
from calibration_tpu_torch.ops import projection_residuals as pr
from calibration_tpu_torch.ops import ransac
from calibration_tpu_torch.optim import BundleOptions, ExtrinsicOptions, IntrinsicsOptimOptions, OptimOptions
from calibration_tpu_torch.optim import optimize_bundle_device, optimize_intrinsics_semidlt_device
from calibration_tpu_torch.parallel import batched, bundle_batch, extrinsics_batch, handeye_batch, homography_batch
from calibration_tpu_torch.parallel import intrinsics_batch, intrinsics_facade_batch, linescan_batch
from calibration_tpu_torch.parallel import linescan_ransac_batch, make_mesh
from calibration_tpu_torch.optim import homography as homography_opt
from calibration_tpu_torch.utils import device_trace, lm_cost_trace, profiling
from calibration_tpu_torch.pipeline import loaders, reports, stages
from calibration_tpu_torch.pipeline.facades import extrinsics as extrinsics_facade_mod
from calibration_tpu_torch.pipeline.facades import intrinsics as facade_mod

KERNEL_ATOL_PX = 5e-3  # f32 rounding of ~640 px values; the JAX kernel's gate
RMS_RTOL_F32 = 1e-5  # K1's RMS mode vs the plain f32 RMS: only the summation order differs
# NVIDIA's H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the
# tensor cores, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# K1's operations per point: R [x, y, 0] + t 12, inverse depth 1, xn/yn 2,
# r^2 3, radial 6, tangential xd 10 and yd 10, K 6, residual * mask 4; RMS
# mode adds rx^2 + ry^2 and the two sums, 5
FLOPS_PER_POINT = {"residuals": 54, "rms": 59}
L2_COLD_BYTES = 120e6  # the cold timing's input sets together: over twice the 50 MB L2
QA_ATOL_PX = 5e-3  # the facade's rms_check warning threshold
COST_PARITY_RTOL = 1e-7  # card vs CPU final robust cost
CAMERA_PARITY_RTOL = 1e-6  # card vs CPU refined camera, app reports
FLEET = 256  # sensors of the app phase
OUTLIERS = 4  # displaced points per view, 20-40 px
PARITY_SENSORS = 8
STEREO_RIGS = 128  # config 3's batch
PIPELINE_RIGS = 64  # the pipeline fleet size of the JAX package's bench_all.py
PIPELINE_PARITY_RIGS = 4
# camera 1's pose vs the truth, on every rig of both phases. At 0.2 px
# noise, with both cameras' intrinsics free, the JAX reference's worst rig
# (CPU, f64) is 11.1 mm / 1.07 deg on the 128-rig stereo set and 14.9 mm /
# 1.58 deg on the 64-rig pipeline, and the port's equals it (noise-free
# data gives 1e-14 m): the bound is about 1.3x that.
POSE_TOL_M = 0.02
POSE_TOL_DEG = 2.0
HOMOG_LANES = 8192  # config 1's batch
HOMOG_PARITY_LANES = 32
HOMOG_OPTS = OptimOptions(max_iterations=50, compute_covariance=False)
HOMOG_RMS_PX = (0.07, 0.11)  # per-coordinate residual RMS for 0.1 px noise
HANDEYE_RIGS = 256  # config 4's batch
HANDEYE_PARITY_RIGS = 16
HANDEYE_OPTS = OptimOptions(max_iterations=50, compute_covariance=False)
# config 4's poses carry no noise: X within the arccos metric's floor
HANDEYE_TOL_DEG = 1e-5
HANDEYE_TOL_M = 1e-7
HE_PIPELINE_RIGS = 64  # the pipeline fleet size of the JAX package's bench_all.py
HE_PIPELINE_PARITY_RIGS = 4
# g_se3_c vs the truth on every rig of the hand-eye pipeline (12 planar
# poses from the linear seed, 0.05 px noise): about 1.3x the JAX
# reference's own worst rig (CPU, f64) on the same 64 generated rigs,
# 41.8 mm / 2.34 deg
HE_POSE_TOL_M = 0.055
HE_POSE_TOL_DEG = 3.1
# g_se3_c vs the truth on every rig after the bundle stage of that pipeline:
# about 1.3x the JAX reference's own worst rig (CPU, f64, the same 64 rigs;
# tools/handeye_pose_reference.py --bundle), 1.31 mm / 0.109 deg
BUNDLE_PIPE_TOL_M = 0.0017
BUNDLE_PIPE_TOL_DEG = 0.14
BUNDLE_RIGS = 128  # config 5's batch
BUNDLE_PARITY_RIGS = 8
BUNDLE_OPTS = BundleOptions(core=OptimOptions(max_iterations=50, compute_covariance=False))
# g_se3_c vs the truth on every lane of config 5 (0.2 px noise, intrinsics
# fixed at the truth): about 1.3x the JAX reference's own worst lane (CPU,
# f64; tools/handeye_pose_reference.py --bundle), 0.253 mm / 0.0225 deg
BUNDLE_TOL_M = 0.00033
BUNDLE_TOL_DEG = 0.029
PINHOLE_NAME = "pinhole_brown_conrady"
SCHEIM_NAME = "scheimpflug_pinhole_brown_conrady"
LINESCAN_RIGS = 1024  # row 5L's batch
LINESCAN_PARITY_RIGS = 32
LINESCAN_RANSAC_RIGS = 256  # rows 5R and 5S
LINESCAN_RANSAC_PARITY_RIGS = 8
LINESCAN_RANSAC_OPTS = dict(max_iters=256, thresh=0.004, min_inliers=20)  # bench_all.py's, thresh in metres
LINESCAN_TILT = (0.06, -0.04)  # row 5S's sensor tilt
LINESCAN_SEEDS = {"5L": 23, "5R": 31, "5S": 37}
# the worst plane-normal angle against the truth on every rig of each row:
# about 1.3x the JAX reference's own worst rig (CPU, f64, the same sets;
# tools/linescan_scheimpflug_reference.py), 0.654 / 0.647 / 0.722 deg
LINESCAN_TOL_DEG = {"5L": 0.85, "5R": 0.85, "5S": 0.94}
LINESCAN_PLANE_PARITY = 1e-9  # card vs CPU planes
SCHEIM_RIGS = 256  # rows 2S and 2T
SCHEIM_PARITY_RIGS = 8
# row: (tilt, (OptimOptions fields, further IntrinsicsOptimOptions fields)),
# as bench_all.py runs 2S (covariance on) and 2T (p1, p2 pinned at 0)
SCHEIM_ROWS = {
    "2S": ((0.05, -0.04), (dict(max_iterations=60, compute_covariance=True), dict(fixed_distortion_indices=(2, 3)))),
    "2T": ((0.09, -0.07), (dict(max_iterations=60, compute_covariance=False),
                           dict(fixed_distortion_indices=(2, 3), fixed_distortion_values=(0.0, 0.0)))),
}
TILT_GATES = (0.006, 0.015, 0.03)  # bench_all.py's: median, p95 and max of |tau - truth|, rad
SCHEIM_RMS_PX = (0.15, 0.25)  # mean view RMS at the injected 0.2 px
WARM_CALLS = 7  # warm calls per timed cell (the median is reported)
PLANAR_CAMERAS = 256  # planar pose: the bench.py set's 256 cameras x 10 views
PLANAR_PARITY_LANES = 32
PLANAR_OPTS = OptimOptions(max_iterations=50)  # the reference's planar_pose_batch default, covariance on
# planar pose's card/CPU parity holds the linearizations and success, not
# the trials: each lane's last linearization sits at the minimum, where
# accepting a step is decided by roundoff (perturbing the data by 1e-15
# relative on the CPU changes the trials of 263 and the stopping tolerance
# of 40 of the 2560 lanes, and the linearizations of none)
PLANAR_PARITY_COUNTERS = ("linearizations", "success")
# each view's pose vs the truth on every lane of the 2560: about 1.3x the
# JAX reference's own worst lane (CPU, f64, the same set;
# tools/solver_reference.py), 4.20 mm / 0.541 deg
PLANAR_TOL_M = 0.0055
PLANAR_TOL_DEG = 0.7
SEMIDLT_CAMERAS = 256
SEMIDLT_PARITY_CAMERAS = 8
SEMIDLT_OPTS = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=60))
# fx, fy, cx, cy (px) and k1, k2 vs the truth on every camera: about 1.3x
# the JAX reference's own worst camera (CPU, f64, the same set;
# tools/solver_reference.py), 6.90 px, 0.053 and 0.708: at 0.2 px noise
# the global distortion fit trades k2 against fx and the poses
SEMIDLT_TOL_PX = 9.0
SEMIDLT_TOL_K = (0.07, 0.92)
SOLVER_TILT = (0.06, -0.04)  # the Scheimpflug stereo and bundle cells' sensor tilt
SOLVER_PARITY_RIGS = 8
# the camera fixed at the truth: camera 1's pose only. The JAX reference's
# worst rig (tools/solver_reference.py) is 1.55 mm / 0.098 deg, well inside
# POSE_TOL
FACADE_OPTS = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=40, epsilon=1e-9, compute_covariance=True))
MESH_SHARDS = 4  # shards of one card in the mesh phase
MESH_FACADE_CAMERAS = 254  # config 2 on the 4-shard mesh: pads to 256
MESH_BUNDLE_RIGS = 126  # config 5 on the 4-shard mesh: pads to 128
MESH_PLANAR_VIEWS = 2558  # planar pose on the 4-shard mesh: pads to 2560
MESH_COST_RTOL = 1e-10  # sharded vs unsharded single-phase final cost, the same card
MESH_WARM_CALLS = 3  # warm calls per arm of the 4-shard cells
MIXED_CAMERAS = 256  # config 2 through intrinsics_batch in each precision
MIXED_COST_RTOL = 1e-7  # mixed / mixed_jac vs f64 final cost, per lane
STEREO_SCHEIM_OPTS = ExtrinsicOptions(core=OptimOptions(max_iterations=50, compute_covariance=False),
                                      optimize_intrinsics=False)


class SmokeFailure(RuntimeError):
    pass


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    print(f"[smoke] ok: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _exp_so3(w):
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    th = np.where(th < 1e-12, 1.0, th)
    a = w / th
    th = th[..., 0]
    k = np.zeros(w.shape[:-1] + (3, 3))
    k[..., 0, 1], k[..., 0, 2] = -a[..., 2], a[..., 1]
    k[..., 1, 0], k[..., 1, 2] = a[..., 2], -a[..., 0]
    k[..., 2, 0], k[..., 2, 1] = -a[..., 1], a[..., 0]
    return np.eye(3) + np.sin(th)[..., None, None] * k + (1 - np.cos(th))[..., None, None] * (k @ k)


def _pose(w, t):
    m = np.eye(4)
    m[:3, :3] = _exp_so3(np.asarray(w, float))
    m[:3, 3] = t
    return m


def _render(intr, c_se3_t, obj, noise, rng):
    """Pixels (V, N, 2) of planar points obj (N, 2) seen from poses
    c_se3_t (V, 4, 4), through the port's pinhole model (a 10-parameter
    camera) or Scheimpflug model (12) on the CPU in float64, plus Gaussian
    noise."""
    obj3 = np.concatenate([obj, np.zeros((obj.shape[0], 1))], -1)
    pc = np.einsum("vij,nj->vni", c_se3_t[:, :3, :3], obj3) + c_se3_t[:, None, :3, 3]
    model = scheimpflug if len(intr) == 12 else pinhole
    uv = model.project(torch.as_tensor(intr), torch.as_tensor(pc)).numpy()
    return uv + rng.normal(0, noise, uv.shape) if noise > 0 else uv


def _grid(rows, cols, pitch):
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    obj = np.stack([xs.ravel() * pitch, ys.ravel() * pitch], -1)
    return obj - obj.mean(0)


def pose_errors(c_se3_r, truth):
    """(max translation error m, max rotation error deg) of camera poses
    (..., 4, 4) against the truth."""
    tra = float(np.abs(c_se3_r[..., :3, 3] - truth[..., :3, 3]).max())
    rel = np.swapaxes(c_se3_r[..., :3, :3], -1, -2) @ truth[..., :3, :3]
    cos = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return tra, float(np.degrees(np.arccos(cos)).max())


def qa_inputs(b, v, n, seed, dtype, mask_dtype, dev):
    """Random QA-recheck inputs on the card (the JAX kernel tests' recipe,
    one camera per problem): c_se3_t (B, V, 4, 4), intrs (B, 10),
    obj_xy/img_uv (B, V, N, 2) of ``dtype``, mask (B, V, N) of
    ``mask_dtype`` with view 3 (or the last) all masked."""
    rng = np.random.default_rng(seed)
    intr = np.tile(np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.15, 0.05, 0.0, 1e-4, -2e-4]), (b, 1))
    intr[:, 0] += rng.normal(0, 5, b)
    poses = np.tile(np.eye(4), (b, v, 1, 1))
    poses[..., :3, :3] = _exp_so3(rng.normal(0, 0.2, (b, v, 3)))
    poses[..., :3, 3] = rng.normal(0, 0.05, (b, v, 3)) + [0, 0, 1.0]
    obj = rng.uniform(-0.15, 0.15, (b, v, n, 2))
    uv = rng.uniform(0, 640, (b, v, n, 2))
    mask = rng.uniform(size=(b, v, n)) > 0.2
    mask.reshape(b * v, n)[min(3, b * v - 1)] = False
    return [torch.as_tensor(a, dtype=t, device=dev)
            for a, t in zip((poses, intr, obj, uv, mask), (dtype,) * 4 + (mask_dtype,))]


def qa_rows(c_se3_t, intrs, obj_xy, img_uv, mask):
    """The QA inputs as the residual op's rows (R = B x V), as the JAX
    reprojection_rms_batch lays them out (copies where the slice or the
    broadcast needs one)."""
    b, v, n = obj_xy.shape[:3]
    return (c_se3_t[..., :3, :3].reshape(b * v, 3, 3), c_se3_t[..., :3, 3].reshape(b * v, 3),
            intrs[:, None, :].expand(b, v, 10).reshape(b * v, 10), obj_xy.reshape(b * v, n, 2),
            img_uv.reshape(b * v, n, 2), mask.reshape(b * v, n))


def old_qa_pass(c_se3_t, intrs, obj_xy, img_uv, mask):
    """The QA recheck as it ran before the RMS mode, from the public pieces:
    float32 copies of the rows, the residual mode, then the RMS in PyTorch."""
    b, v = obj_xy.shape[:2]
    rows = [t.to(torch.float32).contiguous() for t in qa_rows(c_se3_t, intrs, obj_xy, img_uv, mask)]
    return pr._rms_from_residuals(pr.projection_residuals_f32(*rows), rows[5]).reshape(b, v)


# (b, v, n) of the facade and the app (256 cameras x 10 views), of the
# pipeline's intrinsics stage (128 cameras x 10 views), a ragged one and a
# shard of the mesh phase's 4-shard facade (64 cameras x 10 views)
QA_SHAPES = ((256, 10, 88), (2 * PIPELINE_RIGS, 10, 88), (19, 1, 150), (64, 10, 88))
# input and mask dtypes: f32 with a bool mask and with an f32 mask, f64
# with an f64 mask (the facade's)
QA_DTYPES = ((torch.float32, torch.bool), (torch.float32, torch.float32), (torch.float64, torch.float64))


def kernel_phase(dev):
    """Both modes of K1 against their plain versions on the card, at every
    QA_SHAPES shape and QA_DTYPES pair. Returns the worst |kernel - plain
    f64| in px of each mode."""
    worst = {"residuals": 0.0, "rms": 0.0}
    for (b, v, n), seed in zip(QA_SHAPES, (11, 13, 5, 17)):
        for dtype, mask_dtype in QA_DTYPES:
            what = f"{b * v}x{n} {str(dtype)[6:]}/{str(mask_dtype)[6:]} mask"
            args = qa_inputs(b, v, n, seed, dtype, mask_dtype, dev)
            exact = [a.double() for a in args]
            res = pr.projection_residuals_f32(*qa_rows(*args))
            rms = pr.projection_rms_f32(*args)
            torch.cuda.synchronize()
            res64 = pr.projection_residuals_plain(*qa_rows(*exact))
            rms64 = pr._rms_from_residuals(res64, exact[4].reshape(b * v, n)).reshape(b, v)
            rms32 = pr.projection_rms_plain(*args)
            err_res = float((res.double() - res64).abs().max())
            err_rms = float((rms.double() - rms64).abs().max())
            rel32 = float(((rms - rms32).abs() / rms32.clamp(min=1e-30)).max())
            print(f"[smoke] K1 {what}: residuals max|kernel - plain f64| {err_res!r} px; "
                  f"RMS max|kernel - plain f64| {err_rms!r} px, max rel vs plain f32 {rel32!r}")
            check(err_res <= KERNEL_ATOL_PX and err_rms <= KERNEL_ATOL_PX,
                  f"K1 {what}: both modes within {KERNEL_ATOL_PX} px of plain f64")
            check(rel32 <= RMS_RTOL_F32, f"K1 {what}: RMS within {RMS_RTOL_F32} relative of plain f32")
            masked = ~args[4].reshape(b * v, n).bool()
            check(bool((res[masked] == 0).all()) and float(rms.reshape(-1)[min(3, b * v - 1)]) == 0.0,
                  f"K1 {what}: masked residuals exactly 0, the all-masked view's RMS 0")
            worst = {"residuals": max(worst["residuals"], err_res), "rms": max(worst["rms"], err_rms)}
    return worst


def bound_ms(mode, b, v, n, scalar_bytes, mask_bytes):
    """The least time the card could take for one launch: bytes moved (each
    input read once, each output written once) over HBM3's 3.35 TB/s, or
    operations over 67 TFLOP/s f32, whichever is larger. Returns (ms,
    "bytes" or "operations")."""
    rows, points = b * v, b * v * n
    per_point = 4 * scalar_bytes + mask_bytes + (8 if mode == "residuals" else 0)
    # poses: 12 of 16 values per row; intrinsics: per row in residual mode
    # ((R, 10) rows), per camera in RMS mode ((B, 10), shared by the views)
    nbytes = points * per_point + rows * 12 * scalar_bytes + (rows if mode == "residuals" else b) * 10 * scalar_bytes
    nbytes += rows * 4 if mode == "rms" else 0
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = points * FLOPS_PER_POINT[mode] / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bare_launcher(mode, views, out):
    """A call of the C launcher alone (no Python checks, no counter) on
    fixed tensors: what a CUDA graph captures to time the kernel."""
    fn = getattr(_build.load_library(), f"projection_{mode}_launch")
    args = pr.launch_args(*views, out)

    def call():
        err = fn(ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise SmokeFailure(f"K1 {mode} launch failed: CUDA error {err}")
    return call


def graph_ms(calls, replays=20):
    """Device ms per call: ``calls`` captured in order into one CUDA graph,
    whose replays are timed with CUDA events. Returns (ms, graph)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * len(calls)), graph


def profiled_kernel_ms(graph, replays=5):
    """Mean duration of K1's kernel in ``replays`` replays of ``graph`` as
    torch.profiler reads it from the device, without the gaps between
    graph nodes; None when the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if "projection_kernel" in e.key]
    total_us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0) for e in evts)
    count = sum(e.count for e in evts)
    return total_us / count / 1e3 if count and total_us else None


def host_ms(fn, reps=200):
    """Host time per call of ``fn`` issued back to back (no synchronize
    inside the loop, so this is what the host spends issuing it)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e3


def synced_ms(fn, reps=50):
    """Host clock per call of ``fn`` followed by a synchronize."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def timing_phase(dev, b, v, n):
    """K1's device time per mode (CUDA graph replay, L2-warm on one input
    set and L2-cold rotating over enough sets to exceed the 50 MB L2 twice),
    the kernel's own duration from the profiler, the wrapper's host time,
    the bound and its share, the plain versions' device time, and the old
    unfused QA pass beside the RMS mode (device, and host clock with
    synchronize). RMS mode reads float64 with a float64 mask (the facade's
    inputs); residual mode reads float32 with a float32 mask (the JAX
    kernel's inputs). Returns a dict per mode."""
    out = {}
    for mode, dtype in (("rms", torch.float64), ("residuals", torch.float32)):
        size = torch.tensor([], dtype=dtype).element_size()
        bound, bound_by = bound_ms(mode, b, v, n, size, size)
        sets = max(6, math.ceil(L2_COLD_BYTES / (bound * 1e-3 * HBM_BYTES_PER_S)))
        inputs = [qa_inputs(b, v, n, 100 + k, dtype, dtype, dev) for k in range(sets)]
        if mode == "rms":
            outs = [torch.empty((b, v), dtype=torch.float32, device=dev) for _ in range(sets)]
            views = [pr._rms_views(*a) for a in inputs]
            wrapper = lambda: pr.projection_rms_f32(*inputs[0])
            plain = [functools.partial(pr.projection_rms_plain, *a) for a in inputs]
        else:
            outs = [torch.empty((b * v, 1, n, 2), dtype=torch.float32, device=dev) for _ in range(sets)]
            rows = [qa_rows(*a) for a in inputs]
            views = [[t.unsqueeze(1) for t in r] for r in rows]
            wrapper = lambda: pr.projection_residuals_f32(*rows[0])
            plain = [functools.partial(pr.projection_residuals_plain, *r) for r in rows]
        launch = [bare_launcher(mode, vw, o) for vw, o in zip(views, outs)]
        calls = 4 * sets
        warm, warm_graph = graph_ms([launch[0]] * calls)
        cold, cold_graph = graph_ms([launch[k % sets] for k in range(calls)])
        rec = dict(
            ms=cold, ms_warm=warm, kernel_ms_warm=profiled_kernel_ms(warm_graph),
            kernel_ms=profiled_kernel_ms(cold_graph), host_ms=host_ms(wrapper),
            plain_ms=graph_ms([plain[k % sets] for k in range(2 * sets)], replays=5)[0],
            bound_ms=bound, bound_by=bound_by, cold_sets=sets,
        )
        if mode == "rms":
            rec["old_pass_ms"] = graph_ms([functools.partial(old_qa_pass, *inputs[k % sets])
                                           for k in range(2 * sets)], replays=5)[0]
            rec["old_pass_synced_ms"] = synced_ms(lambda: old_qa_pass(*inputs[0]))
            rec["synced_ms"] = synced_ms(wrapper)
        share = {k: bound / rec[k] for k in ("ms", "ms_warm", "kernel_ms", "kernel_ms_warm") if rec[k]}
        print(f"[smoke] K1 {mode} mode {b * v}x{n} from {str(dtype)[6:]}: device {cold!r} ms cold "
              f"({sets} input sets), {warm!r} ms warm (graph replay); kernel alone (profiler) "
              f"{rec['kernel_ms']!r} ms cold, {rec['kernel_ms_warm']!r} ms warm; wrapper host "
              f"{rec['host_ms']!r} ms/call; bound {bound!r} ms ({bound_by}); share of the bound "
              f"{share!r}; plain {rec['plain_ms']!r} ms")
        if mode == "rms":
            print(f"[smoke] QA recheck {b * v}x{n}: old unfused pass {rec['old_pass_ms']!r} ms device, "
                  f"{rec['old_pass_synced_ms']!r} ms host+sync; RMS mode {cold!r} ms device, "
                  f"{rec['synced_ms']!r} ms host+sync")
        out[mode] = rec
        del inputs, outs, views, launch, plain, warm_graph, cold_graph
    return out


def make_problems(batch, views=10, rows=8, cols=11, noise=0.2, seed=7):
    """The bench.py problem set (its make_problems), projected through the
    port's pinhole model on the CPU in float64."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    obj = np.stack([xs.ravel() * 0.03, ys.ravel() * 0.03], -1)
    obj = obj - obj.mean(0)
    intr = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.15, 0.05, 0.0, 1e-4, -2e-4])
    poses = bench_poses(batch, views)
    obj3 = np.concatenate([obj, np.zeros((n, 1))], -1)
    pts_c = np.einsum("bvij,nj->bvni", poses[:, :, :3, :3], obj3) + poses[:, :, None, :3, 3]
    uv = pinhole.project(torch.as_tensor(intr), torch.as_tensor(pts_c)).numpy()
    uv = uv + rng.normal(0, noise, uv.shape)
    return np.tile(obj[None, None], (batch, views, 1, 1)), uv, intr


def _solver_camera(tilt_tau):
    """The benchmark sets' camera: pinhole, or with ``tilt_tau`` the
    Scheimpflug camera with that tilt and zero tangential distortion."""
    if tilt_tau is None:
        return np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.12, 0.04, 0.0, 1e-4, -1e-4])
    return np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.12, 0.04, 0.0, 0.0, 0.0, *tilt_tau])


def stereo_problems(batch, views=8, rows=5, cols=7, noise=0.2, seed=13, tilt_tau=None):
    """The JAX package's stereo benchmark set (its
    benchmarks/problems.py::stereo_problems, BASELINE config 3): B
    two-camera rigs, camera 1 offset per rig, views on a circle, shared
    perturbed inits; through the Scheimpflug camera of ``_solver_camera``
    when ``tilt_tau`` is given. Returns a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    obj = _grid(rows, cols, 0.05)
    n = obj.shape[0]
    intr = _solver_camera(tilt_tau)
    rel_gt = np.stack([_pose([0.02, -0.3 - 0.001 * i, 0.01], [-0.2 - 1e-4 * i, 0.01, 0.015]) for i in range(batch)])
    uv = np.zeros((batch, views, 2, n, 2))
    rts = np.zeros((batch, views, 4, 4))
    for i in range(batch):
        ang = 2 * np.pi * np.arange(views) / views + 0.03 * i
        rts[i] = np.stack([
            _pose([0.3 * np.cos(a), 0.3 * np.sin(a), 0.1 * np.sin(2 * a)],
                  [0.06 * np.cos(a), 0.06 * np.sin(a), 1.0 + 0.08 * np.sin(a)])
            for a in ang
        ])
        uv[i, :, 0] = _render(intr, rts[i], obj, noise, rng)
        uv[i, :, 1] = _render(intr, rel_gt[i] @ rts[i], obj, noise, rng)
    dp = _pose([0.004, -0.003, 0.002], [0.003, -0.002, 0.001])
    c0 = np.stack([np.stack([np.eye(4), rel_gt[i] @ dp]) for i in range(batch)])
    return dict(
        obj=np.tile(obj[None, None, None], (batch, views, 2, 1, 1)), uv=uv,
        intr0=np.tile(intr[None, None], (batch, 2, 1)), c0=c0, r0=rts.copy(), rel_gt=rel_gt,
    )


def homography_problems(batch, n=24, noise=0.1, seed=11):
    """The JAX package's homography benchmark set (its
    benchmarks/problems.py::homography_problems, BASELINE config 1):
    (true H (B, 3, 3), src (B, N, 2), dst (B, N, 2))."""
    rng = np.random.default_rng(seed)
    hs = np.tile(np.eye(3), (batch, 1, 1))
    hs[:, 0, 0] = 1.0 + rng.uniform(-0.2, 0.2, batch)
    hs[:, 1, 1] = 1.0 + rng.uniform(-0.2, 0.2, batch)
    hs[:, 0, 1] = rng.uniform(-0.05, 0.05, batch)
    hs[:, 1, 0] = rng.uniform(-0.05, 0.05, batch)
    hs[:, :2, 2] = rng.uniform(-10, 10, (batch, 2))
    hs[:, 2, :2] = rng.uniform(-2e-4, 2e-4, (batch, 2))
    src = rng.uniform(-2, 2, (batch, n, 2))
    ph = np.concatenate([src, np.ones((batch, n, 1))], -1) @ np.swapaxes(hs, 1, 2)
    dst = ph[..., :2] / ph[..., 2:] + rng.normal(0, noise, (batch, n, 2))
    return hs, src, dst


def handeye_problems(batch, num_poses=20, seed=17):
    """The JAX package's hand-eye benchmark set (its
    benchmarks/problems.py::handeye_problems, BASELINE config 4), poses
    without noise: (g_gt (B, 4, 4), base_se3_gripper (B, P, 4, 4),
    cam_se3_target (B, P, 4, 4)). The camera views are drawn first and the
    gripper poses derived, so the target stays in front of the camera."""
    rng = np.random.default_rng(seed)
    g_gts, bgs, cts = [], [], []
    for i in range(batch):
        g = _pose([0.1 + 1e-3 * i, -0.2, 0.15], [0.02, -0.03, 0.05])
        bg, ct = _handeye_sequence(num_poses, rng, g, _pose([0.05, 0.03, -0.08], [0.4, -0.1, 0.2]))
        g_gts.append(g)
        bgs.append(bg)
        cts.append(ct)
    return np.stack(g_gts), np.stack(bgs), np.stack(cts)


def _handeye_sequence(num_poses, rng, g_se3_c, b_se3_t):
    """``num_poses`` camera views of the target, then the gripper poses
    that give them (base_se3_gripper (P, 4, 4), cam_se3_target (P, 4, 4))."""
    bg, ct = [], []
    for _ in range(num_poses):
        c = _pose(rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.08, 0.08, 3) + np.array([0.0, 0.0, 0.7]))
        bg.append(b_se3_t @ np.linalg.inv(c) @ np.linalg.inv(g_se3_c))
        ct.append(c)
    return np.stack(bg), np.stack(ct)


def bundle_problems(batch, num_obs=20, rows=8, cols=11, noise=0.2, seed=19, tilt_tau=None):
    """The JAX package's bundle benchmark set (its
    benchmarks/problems.py::bundle_problems, BASELINE config 5): B rigs of
    one camera, ``num_obs`` observations of a planar grid with pixel noise,
    and the truth perturbed by fixed small poses as the g0 and b0 seeds;
    through the Scheimpflug camera of ``_solver_camera`` when ``tilt_tau``
    is given. Returns a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    obj = _grid(rows, cols, 0.03)
    intr = _solver_camera(tilt_tau)
    out = {k: [] for k in ("g_gt", "b_gt", "bg", "uv", "g0", "b0")}
    dp = _pose([0.008, -0.006, 0.01], [0.003, -0.002, 0.004])
    dq = _pose([-0.005, 0.007, -0.004], [0.002, 0.003, -0.002])
    for i in range(batch):
        g = _pose([0.1 + 1e-3 * i, -0.2, 0.15], [0.02, -0.03, 0.05])
        bt = _pose([0.05, 0.03, -0.08], [0.4, -0.1, 0.2])
        bg, ct = _handeye_sequence(num_obs, rng, g, bt)
        for key, val in (("g_gt", g), ("b_gt", bt), ("bg", bg), ("uv", _render(intr, ct, obj, noise, rng)),
                         ("g0", g @ dp), ("b0", bt @ dq)):
            out[key].append(val)
    return dict(obj=np.tile(obj[None, None], (batch, num_obs, 1, 1)), intr=intr,
                **{k: np.stack(v) for k, v in out.items()})


def _bench_circle_views(num, dist, tilt, phase):
    """The JAX package's benchmarks/problems.py::circle_views."""
    a = 2 * np.pi * np.arange(num) / num + phase
    return np.stack([
        _pose([tilt * np.cos(x), tilt * np.sin(x), 0.1 * np.sin(2 * x)],
              [0.06 * np.cos(x), 0.06 * np.sin(x), dist + 0.08 * np.sin(x)])
        for x in a
    ])


def linescan_problems(batch, views=6, rows=5, cols=7, n_laser=40, noise=0.1, seed=23, tilt_tau=None):
    """The JAX package's line-scan benchmark set (its
    benchmarks/problems.py::linescan_problems, bench_all.py rows 5L, 5R
    and 5S): B rigs of a camera and a rigidly mounted laser plane, a
    moving 5x7 target at 0.03 m, the laser pixels the projected
    intersection of the two planes, 0.1 px noise; through the Scheimpflug
    model when ``tilt_tau`` is given (then the camera has 12 parameters).
    Projected through the port's models on the CPU in float64. Returns
    (camera (B, pc), obj (B, V, N, 2), target uv (B, V, N, 2), laser uv
    (B, V, L, 2), the true plane (B, 4) with d >= 0)."""
    rng = np.random.default_rng(seed)
    obj = _grid(rows, cols, 0.03)
    intr = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.12, 0.04, 0.0, 1e-4, -1e-4])
    if tilt_tau is not None:
        intr = np.concatenate([intr, np.asarray(tilt_tau, float)])
    model = scheimpflug if tilt_tau is not None else pinhole
    proj = lambda pts: model.project(torch.as_tensor(intr), torch.as_tensor(pts)).numpy()  # noqa: E731
    n_pl = np.array([0.0, np.sin(0.25), -np.cos(0.25)])
    obj3 = np.concatenate([obj, np.zeros((obj.shape[0], 1))], -1)
    tgt_uv = np.zeros((batch, views, obj.shape[0], 2))
    laser_uv = np.zeros((batch, views, n_laser, 2))
    planes = np.zeros((batch, 4))
    s = np.linspace(-0.1, 0.1, n_laser)
    for b in range(batch):
        dist = 0.85 + 0.02 * np.sin(0.7 * b)
        poses = _bench_circle_views(views, dist, 0.25, 0.03 * b)
        d_pl = -n_pl @ np.array([0.0, 0.0, dist])
        sgn = 1.0 if d_pl >= 0 else -1.0
        planes[b] = np.concatenate([sgn * n_pl, [sgn * d_pl]])
        for v in range(views):
            rot, t = poses[v, :3, :3], poses[v, :3, 3]
            tgt_uv[b, v] = proj(obj3 @ rot.T + t) + rng.normal(0, noise, (obj.shape[0], 2))
            ab = rot.T @ n_pl
            c = n_pl @ t + d_pl
            a2 = ab[0] ** 2 + ab[1] ** 2
            pl_xy = (-c * ab[:2] / a2)[None] + s[:, None] * (np.array([-ab[1], ab[0]]) / np.sqrt(a2))[None]
            pts3 = np.concatenate([pl_xy, np.zeros((n_laser, 1))], -1) @ rot.T + t
            laser_uv[b, v] = proj(pts3) + rng.normal(0, noise, (n_laser, 2))
    return np.tile(intr[None], (batch, 1)), np.tile(obj[None, None], (batch, views, 1, 1)), tgt_uv, laser_uv, planes


def with_laser_outliers(laser_uv, seed, share=0.2):
    """bench_all.py's outlier recipe for rows 5R and 5S: ``share`` of the
    laser pixels replaced by uniform [0, 640) junk, drawn from seed + 1."""
    rng = np.random.default_rng(seed + 1)
    out = rng.random(laser_uv.shape[:-1]) < share
    junk = rng.uniform(0, 640, laser_uv.shape)
    return np.where(out[..., None], junk, laser_uv)


def bench_poses(batch, views=10):
    """The bench.py set's camera poses (its make_problems): (B, V, 4, 4)."""
    ang = 2 * np.pi * np.arange(views)[None, :] / views + 0.05 * np.arange(batch)[:, None]
    w = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.1 * np.sin(2 * ang)], axis=-1)
    t = np.stack([0.06 * np.cos(ang), 0.06 * np.sin(ang), 0.9 + 0.08 * np.sin(ang)], axis=-1)
    poses = np.zeros((batch, views, 4, 4))
    poses[..., :3, :3] = _exp_so3(w)
    poses[..., :3, 3] = t
    poses[..., 3, 3] = 1.0
    return poses


def scheimpflug_problems(batch, tilt, seed=7, views=10, rows=8, cols=11, noise=0.2):
    """bench_all.py's Scheimpflug intrinsics sets (rows 2S and 2T): the
    bench.py problems seen through a tilted sensor of ``tilt`` (tau_x,
    tau_y) with zero tangential distortion, noise drawn from seed + 1.
    Returns (obj (B, V, N, 2), uv, the true camera (12,))."""
    obj = _grid(rows, cols, 0.03)
    intr = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.15, 0.05, 0.0, 0.0, 0.0, *tilt])
    poses = bench_poses(batch, views)
    obj3 = np.concatenate([obj, np.zeros((obj.shape[0], 1))], -1)
    pts_c = np.einsum("bvij,nj->bvni", poses[:, :, :3, :3], obj3) + poses[:, :, None, :3, 3]
    uv = scheimpflug.project(torch.as_tensor(intr), torch.as_tensor(pts_c)).numpy()
    uv = uv + np.random.default_rng(seed + 1).normal(0, noise, uv.shape)
    return np.tile(obj[None, None], (batch, views, 1, 1)), uv, intr


STEREO_OPTS = ExtrinsicOptions(core=OptimOptions(max_iterations=50, compute_covariance=False))


def check_stereo(out, rel_gt):
    lm, _, c_se3_r, _, _, _ = out
    b = rel_gt.shape[0]
    check(bool(lm.success.all()), f"all {b} rigs converged")
    tra, rot = pose_errors(c_se3_r[:, 1].cpu().numpy(), rel_gt)
    print(f"[smoke] stereo B={b}: camera 1 vs truth max {tra!r} m, {rot!r} deg; iterations "
          f"{np.bincount(lm.iterations.cpu().numpy()).nonzero()[0].tolist()}")
    check(tra <= POSE_TOL_M and rot <= POSE_TOL_DEG,
          f"camera 1 within {POSE_TOL_M} m and {POSE_TOL_DEG} deg of the truth on every rig")


def stereo_phase(dev, card):
    """Config 3 through extrinsics_batch on the card (phased, B >= 64),
    then the first 8 rigs on the CPU on the same schedule."""
    p = stereo_problems(STEREO_RIGS)
    keys = ("obj", "uv", "intr0", "c0", "r0")
    args = [torch.as_tensor(p[k], device=dev) for k in keys]
    t0 = time.perf_counter()
    out = extrinsics_batch(*args, opts=STEREO_OPTS)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check_stereo(out, p["rel_gt"])
    t0 = time.perf_counter()
    extrinsics_batch(*args, opts=STEREO_OPTS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"[smoke] stereo B={STEREO_RIGS}: first call {first_s!r} s, warm call {warm_s!r} s = "
          f"{STEREO_RIGS / warm_s!r} rigs/s on {card}")
    k = 8
    cpu = extrinsics_batch(*(torch.as_tensor(p[key][:k]) for key in keys), opts=STEREO_OPTS, two_phase=True)
    rel = float(((out[0].cost[:k].cpu() - cpu[0].cost).abs() / cpu[0].cost.abs()).max())
    print(f"[smoke] stereo card vs CPU final cost, first {k} rigs: max rel diff {rel!r}")
    check(rel <= COST_PARITY_RTOL, f"stereo card/CPU cost parity within {COST_PARITY_RTOL} relative")


def detections_payload(sensor_id, obj, uv):
    """A detections JSON payload in the committed format
    (examples/data/detections_cam0.json) for views uv (V, N, 2) of target
    points obj (N, 2)."""
    return {
        "image_directory": "synthetic", "feature_type": "synthetic_grid", "algo_version": "1",
        "params_hash": "synthetic", "sensor_id": sensor_id, "tags": ["synthetic"],
        "metadata": {"detector": {"name": "synthetic_grid"}}, "source_file": "",
        "images": [
            {
                "file": f"{sensor_id}_img_{v:03d}.png",
                "points": [
                    {"x": float(uv[v, j, 0]), "y": float(uv[v, j, 1]), "id": j,
                     "local_x": float(obj[j, 0]), "local_y": float(obj[j, 1]), "local_z": 0.0}
                    for j in range(obj.shape[0])
                ],
            }
            for v in range(uv.shape[0])
        ],
    }


def write_fleet(directory, b, seed=11):
    """The make_problems(b) set as b detections files in the committed
    format (examples/data/detections_cam0.json) plus a config listing the b
    cameras (image 640 x 480, min_corners_per_view 20, RANSAC prefilter at
    its defaults, max_iterations 40, epsilon 1e-9, covariance on). In every
    view OUTLIERS points are displaced by 20-40 px in a random direction,
    from a generator seeded per sensor, so a sensor's data does not depend
    on b. Returns (config path, feature paths, displaced (b, V, N) bool)."""
    directory = Path(directory)
    obj, uv, _ = make_problems(b)
    v, n = uv.shape[1], uv.shape[2]
    displaced = np.zeros((b, v, n), bool)
    features = []
    for i in range(b):
        rng = np.random.default_rng([seed, i])
        for j in range(v):
            pick = rng.choice(n, OUTLIERS, replace=False)
            ang = rng.uniform(0, 2 * np.pi, OUTLIERS)
            uv[i, j, pick] += rng.uniform(20, 40, OUTLIERS)[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
            displaced[i, j, pick] = True
        path = directory / f"detections_cam{i:03d}.json"
        path.write_text(json.dumps(detections_payload(f"cam{i:03d}", obj[i, 0], uv[i])))
        features.append(str(path))
    return write_config(directory, b), features, displaced


def write_config(directory, b) -> str:
    config = {
        "algorithm": "planar",
        "options": {
            "optim_options": {"core": {"max_iterations": 40, "epsilon": 1e-9, "compute_covariance": True}},
            "estim_options": {"homography_ransac": {}},
            "min_corners_per_view": 20,
            "refine": True,
        },
        "cameras": [
            {"camera_id": f"cam{i:03d}", "model": "pinhole_brown_conrady", "image_size": [640, 480]}
            for i in range(b)
        ],
    }
    path = Path(directory) / f"config_{b}.json"
    path.write_text(json.dumps(config))
    return str(path)


APP_LAYERS = (
    (loaders, "read_detections", "ingest"),
    (facade_mod.PlanarIntrinsicCalibrationFacade, "_prefilter", "prefilter"),
    (facade_mod, "intrinsics_facade_batch", "solve"),
    (batched, "reprojection_rms_batch", "qa_kernel"),
    (reports, "build_planar_intrinsics_report", "report"),
    (native, "dumps_fast", "report"),
)
PIPELINE_LAYERS = (
    (loaders.JsonPlanarDatasetLoader, "load", "ingest"),
    (stages.IntrinsicStage, "run", "intrinsics"),
    (stages.StereoCalibrationStage, "run", "stereo"),
    (extrinsics_facade_mod.MultiCameraCalibrationFacade, "calibrate_many", "multicam"),
    (native, "dumps_fast", "writing"),
)


@contextlib.contextmanager
def layer_timers(device: str, targets=APP_LAYERS):
    """Wall time by layer inside an app, each layer closed by a
    synchronize on the card: yields a Counter of seconds filled in as the
    app runs; the wrapped functions are restored on exit."""
    seconds = collections.Counter()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def timed(fn, label):
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                sync()
                seconds[label] += time.perf_counter() - t0
        return wrapper

    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    try:
        for (owner, name, label), (_, _, fn) in zip(targets, saved):
            setattr(owner, name, timed(fn, label))
        yield seconds
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def run_app(config, features, out, device):
    """One planar_intrinsics --fleet call; returns (report JSON, wall s,
    seconds by layer). Its own output goes to a buffer, shown on failure."""
    log = io.StringIO()
    with layer_timers(device, APP_LAYERS) as seconds, contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        t0 = time.perf_counter()
        rc = planar_intrinsics.main(
            ["--fleet", "--device", device, "--config", config, "--features", *features, "-o", str(out)]
        )
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        print(log.getvalue()[-4000:])
    check(rc == 0, f"the app exits 0 on {device} for {len(features)} sensors")
    return json.loads(Path(out).read_text())["reports"][0], wall, seconds


def check_fleet_report(report, displaced):
    cams = report["cameras"]
    check(len(cams) == len(displaced), f"{len(displaced)} camera reports")
    n = displaced.shape[-1]
    exact = all(
        pv["homography"]["inliers"][:n] == (~displaced[i, j]).tolist()
        and not any(pv["homography"]["inliers"][n:])
        for i, cam in enumerate(cams)
        for j, pv in enumerate(cam["per_view"])
    )
    check(exact, "every displaced point rejected and every clean point kept by the prefilter")
    check(all(c["optimization"]["success"] for c in cams), "every camera converged")
    rms = float(np.mean([c["global_rms_px"] for c in cams]))
    print(f"[smoke] app: mean global_rms_px {rms!r}")
    check(0.15 <= rms <= 0.25, "mean global RMS within [0.15, 0.25] px")
    check(all(c["warnings"]["rms_check"] == 0 for c in cams), "no QA recheck warning")


def camera_vector(cam):
    k = cam["camera"]["kmtx"]
    return np.array([k["fx"], k["fy"], k["cx"], k["cy"], k["skew"], *cam["camera"]["distortion"]["coeffs"]])


def check_parity(card, cpu, what, camera=True):
    masks = all(
        [pv["homography"]["inliers"] for pv in a["per_view"]] == [pv["homography"]["inliers"] for pv in b["per_view"]]
        for a, b in zip(card["cameras"], cpu["cameras"])
    )
    check(masks, f"{what}: identical inlier masks")
    cost = max(
        abs(a["optimization"]["final_cost"] - b["optimization"]["final_cost"]) / abs(b["optimization"]["final_cost"])
        for a, b in zip(card["cameras"], cpu["cameras"])
    )
    print(f"[smoke] {what}: final cost max rel diff {cost!r}")
    check(cost <= COST_PARITY_RTOL, f"{what}: final cost within {COST_PARITY_RTOL} relative")
    if camera:
        cam = max(
            float(np.max(np.abs(camera_vector(a) - camera_vector(b)) / np.abs(camera_vector(b)).clip(1e-300)))
            for a, b in zip(card["cameras"], cpu["cameras"])
        )
        print(f"[smoke] {what}: camera max rel diff {cam!r}")
        check(cam <= CAMERA_PARITY_RTOL, f"{what}: camera within {CAMERA_PARITY_RTOL} relative")


# the example data's stereo camera 1 (examples/generate_synthetic.py)
STEREO_OFFSET = _pose([0.02, -0.3, 0.01], [-0.2, 0.0, 0.02])


def write_rigs(directory, rigs, seed=17):
    """``rigs`` stereo rigs as 2 * rigs detections files in the committed
    format, each camera 10 views of an 8x11 grid (0.03 m) with 0.2 px noise
    (the example data's cameras, K = [600, 610, 320, 240, 0], distortion
    [-0.12, 0.04, 0, 1e-4, -5e-5], camera 1 at exp([0.02, -0.3, 0.01]),
    t = [-0.2, 0, 0.02]; the views turn with the rig). Also an intrinsics
    config for the 2 * rigs cameras and a pipeline input with one stereo
    pair and one two-camera multicam rig per rig. A rig's data does not
    depend on ``rigs``. Returns the pipeline input's path."""
    directory = Path(directory)
    intr = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.12, 0.04, 0.0, 1e-4, -5e-5])
    obj = _grid(8, 11, 0.03)
    views = 10
    sensors, pairs, multicam = [], [], []
    for r in range(rigs):
        rng = np.random.default_rng([seed, r])
        ang = 2 * np.pi * np.arange(views) / views + 0.05 * r
        poses0 = np.stack([
            _pose([0.3 * np.cos(a), 0.3 * np.sin(a), 0.1 * np.sin(2 * a)],
                  [0.05 * np.cos(a), 0.05 * np.sin(a), 0.9 + 0.05 * np.sin(a)])
            for a in ang
        ])
        names = []
        for c, poses in enumerate((poses0, STEREO_OFFSET @ poses0)):
            sid = f"rig{r:03d}_cam{c}"
            path = directory / f"detections_{sid}.json"
            path.write_text(json.dumps(detections_payload(sid, obj, _render(intr, poses, obj, 0.2, rng))))
            sensors.append({"sensor_id": sid, "path": path.name})
            names.append(sid)
        files = [[f"{sid}_img_{v:03d}.png" for sid in names] for v in range(views)]
        pairs.append({
            "pair_id": f"pair{r:03d}", "reference_sensor": names[0], "target_sensor": names[1],
            "views": [{"reference_image": a, "target_image": b} for a, b in files],
            "options": {"optimize_intrinsics": True},
        })
        multicam.append({
            "rig_id": f"rig{r:03d}", "sensors": names,
            "views": [{"images": dict(zip(names, f))} for f in files],
            "options": {"optimize_intrinsics": True},
        })
    config = {
        "algorithm": "planar",
        "options": {
            "optim_options": {"core": {"huber_delta": 1.0, "max_iterations": 200}},
            "min_corners_per_view": 20,
            "refine": True,
        },
        "cameras": [
            {"camera_id": s["sensor_id"], "model": "pinhole_brown_conrady", "image_size": [640, 480]}
            for s in sensors
        ],
    }
    (directory / "intrinsics_config.json").write_text(json.dumps(config))
    path = directory / "pipeline_input.json"
    path.write_text(json.dumps({
        "planar_intrinsics_config": "intrinsics_config.json", "planar_detections": sensors,
        "stereo": {"pairs": pairs}, "multicam": multicam,
    }))
    return str(path)


def run_pipeline(input_path, out, device):
    """One intrinsic_extrinsic_pipeline call; returns (artifacts JSON, wall
    s, seconds by layer). Its own output goes to a buffer, shown on
    failure."""
    log = io.StringIO()
    with layer_timers(device, PIPELINE_LAYERS) as seconds, contextlib.redirect_stdout(log), \
            contextlib.redirect_stderr(log):
        t0 = time.perf_counter()
        rc = intrinsic_extrinsic_pipeline.main(["--input", input_path, "--output", str(out), "--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        print(log.getvalue()[-4000:])
    check(rc == 0, f"the pipeline app exits 0 on {device}")
    return json.loads(Path(out).read_text()), wall, seconds


def check_pipeline_artifacts(art, rigs):
    pairs = art["stereo"]["pairs"]
    summary = {s["name"]: s for s in art["pipeline_summary"]["stages"]}
    cams = summary["intrinsics"]["cameras"]
    check(len(cams) == 2 * rigs and all(c["warnings"]["rms_check"] == 0 for c in cams),
          f"intrinsics stage: kernel QA recheck within {QA_ATOL_PX} px of view_errors on all {2 * rigs} cameras")
    check(summary["stereo"]["status"] == "ok"
          and [p["status"] for p in summary["stereo"]["pairs"]] == ["ok"] * rigs, f"all {rigs} stereo pairs ok")
    check(len(art["multicam"]) == rigs and all(r["success"] for r in art["multicam"].values()),
          f"all {rigs} multicam rigs converged")
    for what, entries in (("stereo", pairs.values()), ("multicam", art["multicam"].values())):
        c1 = np.array([e["optimization"]["c_se3_r"][1] for e in entries])
        tra, rot = pose_errors(c1, np.broadcast_to(STEREO_OFFSET, c1.shape))
        print(f"[smoke] pipeline {what}: camera 1 vs truth max {tra!r} m, {rot!r} deg")
        check(tra <= POSE_TOL_M and rot <= POSE_TOL_DEG,
              f"{what}: camera 1 within {POSE_TOL_M} m and {POSE_TOL_DEG} deg of the truth for every rig")


def without_durations(art):
    art = json.loads(json.dumps(art))
    for stage in art["pipeline_summary"]["stages"]:
        stage.pop("duration_s")
    return art


def pipeline_phase(card: str) -> int:
    """The intrinsic_extrinsic_pipeline app over PIPELINE_RIGS rigs on the
    card, then card/CPU parity on PIPELINE_PARITY_RIGS rigs. Returns the
    kernel launches of the app's first call, the path's counted run."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_helpers import assert_reports_match

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (Path(tmp) / "fleet").mkdir()
        input_path = write_rigs(Path(tmp) / "fleet", PIPELINE_RIGS)
        print(f"[smoke] pipeline: wrote {2 * PIPELINE_RIGS} detections files in {time.perf_counter() - t0!r} s")
        launches = None
        for call in ("first", "warm"):
            zero_launches()
            art, wall, seconds = run_pipeline(input_path, Path(tmp) / f"artifacts_{call}.json", "cuda")
            if launches is None:
                launches = k1_launches()["rms"]  # the path's one counted run; the warm call repeats it
            layers = ", ".join(f"{k} {v!r} s" for k, v in sorted(seconds.items()))
            print(f"[smoke] pipeline {call} call: {wall!r} s = {PIPELINE_RIGS / wall!r} rigs/s on {card}; "
                  f"{layers}; other {wall - sum(seconds.values())!r} s; K1 launches {k1_launches()}")
            check_pipeline_artifacts(art, PIPELINE_RIGS)
            check(k1_launches()["rms"] > 0, "the pipeline's intrinsics stage launched K1 in RMS mode")

        k = PIPELINE_PARITY_RIGS
        (Path(tmp) / "small").mkdir()
        small = write_rigs(Path(tmp) / "small", k)
        cpu, _, _ = run_pipeline(small, Path(tmp) / "artifacts_cpu.json", "cpu")
        card_k, _, _ = run_pipeline(small, Path(tmp) / "artifacts_card4.json", "cuda")
        assert_reports_match(without_durations(cpu), without_durations(card_k))
        print(f"[smoke] ok: pipeline card vs CPU artifacts on {k} rigs within the report bounds")
    return launches


def app_phase(card: str) -> int:
    """The planar_intrinsics app over FLEET sensors on the card, then
    card/CPU parity on the first PARITY_SENSORS. Returns the kernel
    launches of the app's first call, the path's counted run."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        config, features, displaced = write_fleet(tmp, FLEET)
        print(f"[smoke] app: wrote {FLEET} detections files in {time.perf_counter() - t0!r} s")
        launches = None
        for call in ("first", "warm"):
            zero_launches()
            rounds = ransac_rounds("cuda")
            report, wall, seconds = run_app(config, features, Path(tmp) / f"report_{call}.json", "cuda")
            rounds = ransac_rounds("cuda") - rounds
            if launches is None:
                launches = k1_launches()["rms"]  # the path's one counted run; the warm call repeats it
            layers = ", ".join(f"{k} {v!r} s" for k, v in sorted(seconds.items()))
            print(f"[smoke] app {call} call: {wall!r} s = {FLEET / wall!r} sensors/s on {card}; {layers}; "
                  f"other {wall - sum(seconds.values())!r} s; K1 launches {k1_launches()}, "
                  f"prefilter rounds on the card {rounds}")
            check_fleet_report(report, displaced)
            check(k1_launches()["rms"] > 0, "the app launched K1 in RMS mode")
            check(rounds > 0, "the app's RANSAC prefilter ran on the card")

        k = PARITY_SENSORS
        config_k = write_config(tmp, k)
        cpu, _, _ = run_app(config_k, features[:k], Path(tmp) / "report_cpu.json", "cpu")
        card_k, _, _ = run_app(config_k, features[:k], Path(tmp) / "report_card8.json", "cuda")
        check_parity(card_k, cpu, f"app card vs CPU, {k} sensors")
        fleet_k = dict(report, cameras=report["cameras"][:k])
        # the fleet solve runs two LM phases, the 8-sensor solves one: the
        # minimum agrees in cost, not along the flat fx/k3 valley
        check_parity(fleet_k, cpu, f"app card ({FLEET} sensors) vs CPU, first {k}", camera=False)
    return launches


def residual_rms(h, src, dst):
    """Per-lane per-coordinate transfer residual RMS (numpy, float64)."""
    ph = np.concatenate([src, np.ones(src.shape[:-1] + (1,))], -1) @ np.swapaxes(h, -1, -2)
    r = ph[..., :2] / ph[..., 2:] - dst
    return np.sqrt(np.mean(r * r, axis=(-2, -1)))


def transfer_cost(h, src, dst):
    """bench_all.py's shared numpy evaluator of a homography's squared
    transfer error, per lane."""
    ph = np.concatenate([src, np.ones(src.shape[:-1] + (1,))], -1) @ np.swapaxes(h, -1, -2)
    r = ph[..., :2] / ph[..., 2:] - dst
    return np.sum(r * r, axis=(-2, -1))


def timed(fn, dev):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def homography_phase(dev, card):
    """Config 1 through homography_batch on the card (phased, f64 seed):
    first and warm call, checks, card/CPU transfer-cost parity on the first
    HOMOG_PARITY_LANES lanes (same schedule). The first-phase cap sweep is
    tools/profile_torch_cells.py's."""
    _, src, dst = homography_problems(HOMOG_LANES)
    s_d, d_d = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
    run = functools.partial(homography_batch, s_d, d_d, options=HOMOG_OPTS)
    out, first_s = timed(run, dev)
    lm, hm = out[0], out[1].cpu().numpy()
    check(bool(lm.success.all()), f"all {HOMOG_LANES} homographies converged")
    rms = float(residual_rms(hm, src, dst).mean())
    lin = np.bincount(lm.linearizations.cpu().numpy()).tolist()
    print(f"[smoke] homography B={HOMOG_LANES}: mean residual RMS {rms!r} px; linearizations histogram {lin}; "
          f"trials max {int(lm.iterations.max())}")
    check(HOMOG_RMS_PX[0] <= rms <= HOMOG_RMS_PX[1], f"mean residual RMS within {list(HOMOG_RMS_PX)} px")
    _, warm_s = timed(run, dev)
    print(f"[smoke] homography B={HOMOG_LANES}: first call {first_s!r} s, warm call {warm_s!r} s = "
          f"{HOMOG_LANES / warm_s!r} solves/s on {card}")
    k = HOMOG_PARITY_LANES
    cpu = homography_batch(torch.as_tensor(src[:k]), torch.as_tensor(dst[:k]), options=HOMOG_OPTS, two_phase=True)
    c_card, c_cpu = transfer_cost(hm[:k], src[:k], dst[:k]), transfer_cost(cpu[1].numpy(), src[:k], dst[:k])
    rel = float((np.abs(c_card - c_cpu) / c_cpu).max())
    print(f"[smoke] homography card vs CPU transfer cost, first {k} lanes: max rel diff {rel!r}")
    check(rel <= COST_PARITY_RTOL, f"homography card/CPU cost parity within {COST_PARITY_RTOL} relative")
    return warm_s


def handeye_phase(dev, card):
    """Config 4 through handeye_batch on the card: checks, card/CPU parity
    on the first HANDEYE_PARITY_RIGS rigs, warm rigs/s."""
    g_gt, bg, ct = handeye_problems(HANDEYE_RIGS)
    bg_d, ct_d = torch.as_tensor(bg, device=dev), torch.as_tensor(ct, device=dev)
    run = functools.partial(handeye_batch, bg_d, ct_d, options=HANDEYE_OPTS)
    out, first_s = timed(run, dev)
    lm, pose = out[0], out[1].cpu().numpy()
    check(bool(lm.success.all()), f"all {HANDEYE_RIGS} hand-eye rigs converged")
    tra, rot = pose_errors(pose, g_gt)
    print(f"[smoke] hand-eye B={HANDEYE_RIGS}: X vs truth max {tra!r} m, {rot!r} deg; linearizations "
          f"{np.bincount(lm.linearizations.cpu().numpy()).tolist()}")
    check(tra <= HANDEYE_TOL_M and rot <= HANDEYE_TOL_DEG,
          f"X within {HANDEYE_TOL_M} m and {HANDEYE_TOL_DEG} deg of the truth on every rig")
    _, warm_s = timed(run, dev)
    print(f"[smoke] hand-eye B={HANDEYE_RIGS}: first call {first_s!r} s, warm call {warm_s!r} s = "
          f"{HANDEYE_RIGS / warm_s!r} rigs/s on {card}")
    k = HANDEYE_PARITY_RIGS
    cpu = handeye_batch(torch.as_tensor(bg[:k]), torch.as_tensor(ct[:k]), options=HANDEYE_OPTS)
    diff = float(np.abs(pose[:k] - cpu[1].numpy()).max())
    same = all(torch.equal(getattr(lm, f)[:k].cpu(), getattr(cpu[0], f)) for f in ("iterations", "linearizations"))
    print(f"[smoke] hand-eye card vs CPU, first {k} rigs: max |X diff| {diff!r}, same counters {same}")
    check(diff <= 1e-9 and same, "hand-eye card/CPU parity: X within 1e-9, the same counters")
    return warm_s


def bundle_args(p, device):
    """bundle_batch's arguments for a bundle_problems set, as
    bench_all.py's config 5 passes them: one camera (cam_idx zeros), its
    intrinsics fixed at the truth, the perturbed g0 and b0 seeds."""
    b, o = p["bg"].shape[:2]
    arrays = (p["obj"], p["uv"], p["bg"], np.zeros((b, o), np.int64), np.tile(p["intr"][None, None], (b, 1, 1)),
              p["g0"][:, None], p["b0"])
    return [torch.as_tensor(a, device=device) for a in arrays]


def check_bundle(out, p):
    lm, _, g_se3_c, _, _, _ = out
    b = p["g_gt"].shape[0]
    check(bool(lm.success.all()), f"all {b} bundle rigs converged")
    tra, rot = pose_errors(g_se3_c[:, 0].cpu().numpy(), p["g_gt"])
    print(f"[smoke] bundle B={b}: g_se3_c vs truth max {tra!r} m, {rot!r} deg; linearizations histogram "
          f"{np.bincount(lm.linearizations.cpu().numpy()).tolist()}; trials max {int(lm.iterations.max())}")
    check(tra <= BUNDLE_TOL_M and rot <= BUNDLE_TOL_DEG,
          f"g_se3_c within {BUNDLE_TOL_M} m and {BUNDLE_TOL_DEG} deg of the truth on every rig")


def bundle_phase(dev, card):
    """Config 5 through bundle_batch on the card: checks, the first call
    and the median of WARM_CALLS warm calls, card/CPU parity on the
    first BUNDLE_PARITY_RIGS rigs on the same schedule. Returns the warm
    median in s."""
    p = bundle_problems(BUNDLE_RIGS)
    run = functools.partial(bundle_batch, *bundle_args(p, dev), opts=BUNDLE_OPTS)
    out, first_s = timed(run, dev)
    check_bundle(out, p)
    med, warm = warm_median(run, dev)
    print(f"[smoke] bundle B={BUNDLE_RIGS}: first call {first_s!r} s, warm median {med!r} s = "
          f"{BUNDLE_RIGS / med!r} rigs/s on {card} (warm calls {warm!r})")
    k = BUNDLE_PARITY_RIGS
    head = dict(p, **{key: p[key][:k] for key in ("obj", "uv", "bg", "g0", "b0")})
    cpu = bundle_batch(*bundle_args(head, "cpu"), opts=BUNDLE_OPTS,
                       two_phase=BUNDLE_RIGS >= batched.TWO_PHASE_MIN_BATCH)
    rel = float(((out[0].cost[:k].cpu() - cpu[0].cost).abs() / cpu[0].cost.abs()).max())
    same = all(torch.equal(getattr(out[0], f)[:k].cpu(), getattr(cpu[0], f)) for f in ("iterations", "termination"))
    print(f"[smoke] bundle card vs CPU, first {k} rigs: final cost max rel diff {rel!r}, same iterations and "
          f"termination {same}")
    check(rel <= COST_PARITY_RTOL and same,
          f"bundle card/CPU parity: cost within {COST_PARITY_RTOL} relative, the same iterations and termination")
    return med


def write_handeye_fleet(directory, rigs, num_obs=12, rows=8, cols=11, noise=0.05, seed=29):
    """The JAX package's robot-cell pipeline fleet (its
    benchmarks/pipeline_fleet.py::make_fleet): ``rigs`` robot cells, each
    one camera with its own hand-eye transform and base -> target pose and
    ``num_obs`` observations, written as detections files, a
    planar-intrinsics config and a pipeline input with hand-eye and bundle
    sections. The bundle rigs have no observations of their own (the stage
    takes the hand-eye rig's) and fixed intrinsics; ``pipeline_variant``
    derives the other inputs. One generator runs over the rigs in order, so
    a rig's data does not depend on ``rigs``. Returns dict(obj, uv, bg,
    ct_gt (R, O, ...), intr, g_gt, bt_gt (R, 4, 4), input_path)."""
    out = Path(directory)
    rng = np.random.default_rng(seed)
    obj = _grid(rows, cols, 0.03)
    n = obj.shape[0]
    intr = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.12, 0.04, 0.0, 1e-4, -5e-5])
    arrays = {k: np.zeros((rigs, num_obs) + s) for k, s in (("uv", (n, 2)), ("bg", (4, 4)), ("ct_gt", (4, 4)))}
    g_b, bt_b = np.zeros((rigs, 4, 4)), np.zeros((rigs, 4, 4))
    sensors, cameras, he_rigs = [], [], []
    for r in range(rigs):
        sensor = f"cam{r}"
        g = _pose(rng.uniform(-0.3, 0.3, 3), rng.uniform(-0.06, 0.06, 3))
        bt = _pose(rng.uniform(-0.2, 0.2, 3), [0.4, -0.1, 0.2] + rng.uniform(-0.05, 0.05, 3))
        g_b[r], bt_b[r] = g, bt
        obs = []
        for i in range(num_obs):
            ct = _pose(rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.08, 0.08, 3) + [0, 0, 0.8])
            bg = bt @ np.linalg.inv(ct) @ np.linalg.inv(g)
            arrays["uv"][r, i] = _render(intr, ct[None], obj, 0.0, rng)[0] + rng.normal(0, noise, (n, 2))
            arrays["bg"][r, i], arrays["ct_gt"][r, i] = bg, ct
            obs.append({"view_id": f"v{i}", "base_se3_gripper": bg.tolist(), "images": {sensor: f"{sensor}_he_{i:03d}.png"}})
        payload = detections_payload(sensor, obj, arrays["uv"][r])
        for i, img in enumerate(payload["images"]):
            img["file"] = f"{sensor}_he_{i:03d}.png"
        (out / f"detections_{sensor}.json").write_text(json.dumps(payload))
        sensors.append({"sensor_id": sensor, "path": f"detections_{sensor}.json"})
        cameras.append({"camera_id": sensor, "model": "pinhole_brown_conrady", "image_size": [640, 480]})
        he_rigs.append({"rig_id": f"rig{r}", "sensors": [sensor], "observations": obs,
                        "options": {"huber_delta": 1.0}, "min_angle_deg": 1.0})
    (out / "planar_intrinsics_config.json").write_text(json.dumps({
        "algorithm": "planar",
        "options": {"optim_options": {"core": {"huber_delta": 1.0, "max_iterations": 200}},
                    "min_corners_per_view": 20, "refine": True},
        "cameras": cameras,
    }))
    bundle_rigs = [
        {"rig_id": f"rig{r}", "sensors": [f"cam{r}"], "options": {"optimize_intrinsics": False}, "min_angle_deg": 1.0}
        for r in range(rigs)
    ]
    input_path = out / "bundle_input.json"
    input_path.write_text(json.dumps({
        "planar_intrinsics_config": "planar_intrinsics_config.json", "planar_detections": sensors,
        "hand_eye": {"rigs": he_rigs}, "bundle": {"rigs": bundle_rigs},
    }))
    return dict(obj=np.tile(obj[None, None], (rigs, num_obs, 1, 1)), **arrays, intr=intr, g_gt=g_b, bt_gt=bt_b,
                input_path=str(input_path))


HANDEYE_LAYERS = (
    (loaders.JsonPlanarDatasetLoader, "load", "ingest"),
    (stages.IntrinsicStage, "run", "intrinsics"),
    (stages.HandEyeCalibrationStage, "run", "hand_eye"),
    (stages.BundleAdjustmentStage, "run", "bundle"),
    (native, "dumps_fast", "writing"),
)


def pipeline_variant(input_path, variant) -> str:
    """A copy of a ``write_handeye_fleet`` input beside it:
    "handeye" drops the bundle section (intrinsics, then hand-eye);
    "staged" moves the hand-eye rigs' observations into the bundle rigs and
    drops the hand-eye section, so the bundle stage seeds every rig by DLT
    and takes its staged path. Returns the copy's path."""
    data = json.loads(Path(input_path).read_text())
    if variant == "handeye":
        data.pop("bundle")
    elif variant == "staged":
        for rig, he_rig in zip(data["bundle"]["rigs"], data.pop("hand_eye")["rigs"]):
            rig["observations"] = he_rig["observations"]
    else:
        raise ValueError(variant)
    path = Path(input_path).with_name(f"{variant}_input.json")
    path.write_text(json.dumps(data))
    return str(path)


def run_handeye_pipeline(input_path, out, device):
    """One bundle_pipeline call; returns (artifacts JSON, wall s, seconds
    by layer). Its own output goes to a buffer, shown on failure."""
    log = io.StringIO()
    with layer_timers(device, HANDEYE_LAYERS) as seconds, contextlib.redirect_stdout(log), \
            contextlib.redirect_stderr(log):
        t0 = time.perf_counter()
        rc = bundle_pipeline.main(["--input", input_path, "--output", str(out), "--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        print(log.getvalue()[-4000:])
    check(rc == 0, f"the hand-eye pipeline app exits 0 on {device}")
    return json.loads(Path(out).read_text()), wall, seconds


def check_handeye_artifacts(art, fleet, source="handeye"):
    """The pipeline's checks: K1's QA recheck on every camera; every
    hand-eye rig ok within HE_POSE_TOL of the truth when the hand-eye stage
    ran; every bundle rig ok within BUNDLE_PIPE_TOL, each hand-eye init
    from ``source``, when the bundle stage ran."""
    rigs = fleet["g_gt"].shape[0]
    summary = {s["name"]: s for s in art["pipeline_summary"]["stages"]}
    cams = summary["intrinsics"]["cameras"]
    check(len(cams) == rigs and all(c["warnings"]["rms_check"] == 0 for c in cams),
          f"intrinsics stage: kernel QA recheck within {QA_ATOL_PX} px of view_errors on all {rigs} cameras")
    if "hand_eye" in summary:
        statuses = [art["hand_eye"][f"rig{r}"]["sensors"][f"cam{r}"]["status"] for r in range(rigs)]
        check(statuses == ["ok"] * rigs and summary["hand_eye"]["status"] == "ok", f"all {rigs} hand-eye rigs ok")
        g = np.array([art["hand_eye"][f"rig{r}"]["sensors"][f"cam{r}"]["g_se3_c"] for r in range(rigs)])
        tra, rot = pose_errors(g, fleet["g_gt"])
        print(f"[smoke] hand-eye pipeline: hand-eye g_se3_c vs truth max {tra!r} m, {rot!r} deg")
        check(tra <= HE_POSE_TOL_M and rot <= HE_POSE_TOL_DEG,
              f"hand-eye g_se3_c within {HE_POSE_TOL_M} m and {HE_POSE_TOL_DEG} deg of the truth for every rig")
    if "bundle" in summary:
        rig_sums = summary["bundle"]["rigs"]
        check([r["status"] for r in rig_sums] == ["ok"] * rigs and summary["bundle"]["status"] == "ok",
              f"all {rigs} bundle rigs ok")
        sources = {e["source"] for r in rig_sums for e in r["handeye_initialization"]}
        check(sources == {source}, f"every bundle hand-eye init from '{source}' ({sorted(sources)})")
        g = np.array([art["bundle"][f"rig{r}"]["result"]["g_se3_c"][0] for r in range(rigs)])
        tra, rot = pose_errors(g, fleet["g_gt"])
        print(f"[smoke] bundle pipeline ({source} seeds): bundle g_se3_c vs truth max {tra!r} m, {rot!r} deg")
        check(tra <= BUNDLE_PIPE_TOL_M and rot <= BUNDLE_PIPE_TOL_DEG,
              f"bundle g_se3_c within {BUNDLE_PIPE_TOL_M} m and {BUNDLE_PIPE_TOL_DEG} deg of the truth for every rig")


def homography_app_check(directory, card):
    """The homography app on the card on the first config-1 problem, with
    and without a RANSAC section: exit 0, the refine converged, its
    homography within 1e-9 of the CPU app's."""
    _, src, dst = homography_problems(1)
    corr = [{"object_xy": s_.tolist(), "image_uv": d_.tolist()} for s_, d_ in zip(src[0], dst[0])]
    for name, extra in (("dlt", {}), ("ransac", {"ransac": {"thresh": 1.0}})):
        path = Path(directory) / f"homography_{name}.json"
        path.write_text(json.dumps({"correspondences": corr, "optimize": True, **extra}))
        outs = {}
        for device in ("cuda", "cpu"):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = homography_app.main(["--input", str(path), "-o", str(path.with_suffix(f".{device}.out")),
                                          "--device", device])
            check(rc == 0, f"the homography app ({name}) exits 0 on {device}")
            outs[device] = json.loads(path.with_suffix(f".{device}.out").read_text())
        diff = float(np.abs(np.array(outs["cuda"]["optimized"]["homography"])
                            - np.array(outs["cpu"]["optimized"]["homography"])).max())
        check(outs["cuda"]["optimized"]["core"]["success"] and diff <= 1e-9,
              f"homography app ({name}) on {card}: refined, within 1e-9 of the CPU app ({diff!r})")


def handeye_pipeline_phase(card: str) -> int:
    """The four-stage bundle_pipeline app (intrinsics, hand-eye, bundle)
    over HE_PIPELINE_RIGS robot cells on the card, then card/CPU parity on
    HE_PIPELINE_PARITY_RIGS rigs with the bundle section, without it, and
    with the hand-eye section's observations moved into the bundle rigs
    (DLT seeds, the staged path), then the homography app. Returns the K1
    launches of the app's first call, the path's counted run."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_helpers import assert_reports_match

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (Path(tmp) / "fleet").mkdir()
        fleet = write_handeye_fleet(Path(tmp) / "fleet", HE_PIPELINE_RIGS)
        print(f"[smoke] hand-eye pipeline: wrote {HE_PIPELINE_RIGS} detections files in "
              f"{time.perf_counter() - t0!r} s")
        launches = None
        for call in ("first", "warm"):
            zero_launches()
            art, wall, seconds = run_handeye_pipeline(fleet["input_path"], Path(tmp) / f"he_{call}.json", "cuda")
            if launches is None:
                launches = k1_launches()["rms"]  # the path's one counted run; the warm call repeats it
            layers = ", ".join(f"{k} {v!r} s" for k, v in sorted(seconds.items()))
            print(f"[smoke] hand-eye pipeline {call} call: {wall!r} s = {HE_PIPELINE_RIGS / wall!r} rigs/s on "
                  f"{card}; {layers}; other {wall - sum(seconds.values())!r} s; K1 launches {k1_launches()}")
            check_handeye_artifacts(art, fleet)
            check(k1_launches()["rms"] > 0, "the hand-eye pipeline's intrinsics stage launched K1 in RMS mode")

        k = HE_PIPELINE_PARITY_RIGS
        (Path(tmp) / "small").mkdir()
        small = write_handeye_fleet(Path(tmp) / "small", k)
        for variant, source in (("bundle", "handeye"), ("handeye", None), ("staged", "dlt")):
            path = small["input_path"] if variant == "bundle" else pipeline_variant(small["input_path"], variant)
            cpu, _, _ = run_handeye_pipeline(path, Path(tmp) / f"{variant}_cpu.json", "cpu")
            card_k, _, _ = run_handeye_pipeline(path, Path(tmp) / f"{variant}_card.json", "cuda")
            check_handeye_artifacts(card_k, small, source)
            assert_reports_match(without_durations(cpu), without_durations(card_k))
            print(f"[smoke] ok: pipeline ({variant}) card vs CPU artifacts on {k} rigs within the report bounds")
        homography_app_check(tmp, card)
    return launches


def plane_angles_deg(plane, truth):
    """Per-rig angle between fitted and true plane normals, sign-free."""
    cos = np.abs(np.sum(plane[:, :3] * truth[:, :3], -1))
    return np.degrees(np.arccos(np.clip(cos, 0.0, 1.0)))


def warm_median(run, dev):
    """The median of WARM_CALLS warm calls in s, and the calls."""
    warm = [timed(run, dev)[1] for _ in range(WARM_CALLS)]
    return float(np.median(warm)), warm


def check_no_launches(what):
    check(k1_launches() == {"residuals": 0, "rms": 0}, f"{what} launched no K1 kernel (the path has none)")


def linescan_phase(dev, card):
    """Row 5L through linescan_batch on the card: every rig ok, the plane
    normal within LINESCAN_TOL_DEG of the truth, first call and the median
    of WARM_CALLS warm calls, card/CPU planes on LINESCAN_PARITY_RIGS rigs.
    Returns the warm median in s."""
    p = linescan_problems(LINESCAN_RIGS, seed=LINESCAN_SEEDS["5L"])
    run = functools.partial(linescan_batch, *(torch.as_tensor(a, device=dev) for a in p[:4]))
    zero_launches()
    res, first_s = timed(run, dev)
    check_no_launches("row 5L")
    angle = float(plane_angles_deg(res.plane.cpu().numpy(), p[4]).max())
    print(f"[smoke] line-scan B={LINESCAN_RIGS} (5L): worst plane-normal angle {angle!r} deg, "
          f"rms_error max {float(res.rms_error.max())!r} m")
    check(bool(res.ok.all()), f"all {LINESCAN_RIGS} line-scan rigs ok")
    check(angle <= LINESCAN_TOL_DEG["5L"], f"every 5L plane normal within {LINESCAN_TOL_DEG['5L']} deg of the truth")
    med, warm = warm_median(run, dev)
    print(f"[smoke] line-scan B={LINESCAN_RIGS} (5L): first call {first_s!r} s, warm median {med!r} s = "
          f"{LINESCAN_RIGS / med!r} rigs/s on {card} (warm calls {warm!r})")
    k = LINESCAN_PARITY_RIGS
    cpu = linescan_batch(*(torch.as_tensor(a[:k]) for a in p[:4]))
    diff = float((res.plane[:k].cpu() - cpu.plane).abs().max())
    print(f"[smoke] line-scan card vs CPU, first {k} rigs: max |plane diff| {diff!r}")
    check(diff <= LINESCAN_PLANE_PARITY and torch.equal(res.inlier_count[:k].cpu(), cpu.inlier_count),
          f"line-scan card/CPU planes within {LINESCAN_PLANE_PARITY}, the same point counts")
    return med


def linescan_ransac_problems(row, tilt):
    """Row 5R's or 5S's set (``tilt`` None: the pinhole camera) with its
    junk laser pixels."""
    seed = LINESCAN_SEEDS[row]
    camera, obj, tuv, luv, truth = linescan_problems(LINESCAN_RANSAC_RIGS, seed=seed, tilt_tau=tilt)
    return camera, obj, tuv, with_laser_outliers(luv, seed), truth


def linescan_ransac_phase(dev, card, row):
    """Row 5R (pinhole) or 5S (Scheimpflug, and beside it the same set
    through the pinhole camera) through linescan_ransac_batch on the card:
    every rig ok, the plane normal within LINESCAN_TOL_DEG, RANSAC rounds on
    the card, first call and warm median, card/CPU on
    LINESCAN_RANSAC_PARITY_RIGS rigs (both draw the same noise: equal
    inliers, planes within LINESCAN_PLANE_PARITY). Returns the warm median
    in s."""
    tilt = LINESCAN_TILT if row == "5S" else None
    model = SCHEIM_NAME if tilt else PINHOLE_NAME
    p = linescan_ransac_problems(row, tilt)
    opts = ransac.RansacOptions(**LINESCAN_RANSAC_OPTS)
    run = functools.partial(linescan_ransac_batch, *(torch.as_tensor(a, device=dev) for a in p[:4]), options=opts,
                            model_name=model)
    zero_launches()
    rounds = ransac_rounds(dev.type)
    res, first_s = timed(run, dev)
    rounds = ransac_rounds(dev.type) - rounds
    check_no_launches(f"row {row}")
    angle = float(plane_angles_deg(res.plane.cpu().numpy(), p[4]).max())
    counts = res.inlier_count.cpu().numpy()
    print(f"[smoke] line-scan RANSAC B={LINESCAN_RANSAC_RIGS} ({row}, {model}): worst plane-normal angle {angle!r} "
          f"deg, inliers min {int(counts.min())} / median {float(np.median(counts))} of {p[3].shape[1] * p[3].shape[2]}"
          f" laser pixels, RANSAC rounds on the card {rounds}")
    check(bool(res.ok.all()), f"all {LINESCAN_RANSAC_RIGS} {row} rigs ok")
    check(angle <= LINESCAN_TOL_DEG[row], f"every {row} plane normal within {LINESCAN_TOL_DEG[row]} deg of the truth")
    check(rounds > 0, f"row {row}'s RANSAC ran on the card")
    med, warm = warm_median(run, dev)
    print(f"[smoke] line-scan RANSAC B={LINESCAN_RANSAC_RIGS} ({row}): first call {first_s!r} s, warm median {med!r} "
          f"s = {LINESCAN_RANSAC_RIGS / med!r} rigs/s on {card} (warm calls {warm!r})")
    if tilt is not None:
        q = linescan_ransac_problems(row, None)
        pin = functools.partial(linescan_ransac_batch, *(torch.as_tensor(a, device=dev) for a in q[:4]), options=opts)
        pin()
        pin_med, _ = warm_median(pin, dev)
        print(f"[smoke] line-scan RANSAC B={LINESCAN_RANSAC_RIGS} ({row}): the same set through the pinhole camera "
              f"warm median {pin_med!r} s; Scheimpflug rate / pinhole rate {pin_med / med!r}")
    k = LINESCAN_RANSAC_PARITY_RIGS
    cpu = linescan_ransac_batch(*(torch.as_tensor(a[:k]) for a in p[:4]), options=opts, model_name=model)
    diff = float((res.plane[:k].cpu() - cpu.plane).abs().max())
    same = torch.equal(res.inlier_count[:k].cpu(), cpu.inlier_count) and torch.equal(res.ok[:k].cpu(), cpu.ok)
    print(f"[smoke] line-scan RANSAC ({row}) card vs CPU, first {k} rigs: max |plane diff| {diff!r}, "
          f"same inlier counts and ok {same}")
    check(diff <= LINESCAN_PLANE_PARITY and same,
          f"{row} card/CPU: planes within {LINESCAN_PLANE_PARITY}, the same inlier counts and ok")
    return med


def scheimpflug_opts(row):
    _, (core, extra) = SCHEIM_ROWS[row]
    return IntrinsicsOptimOptions(core=OptimOptions(**core), **extra)


def check_scheimpflug(out, truth, row):
    """Row 2S's or 2T's gates: every lane converged, bench_all.py's tilt
    gates, the mean view RMS at the injected noise, covariance finite when
    on. Returns the tilt deviation's (median, p95, max)."""
    lm, intr, _, view_errors, cov, cov_ok = out
    b = intr.shape[0]
    tilt_dev = np.abs(intr[:, 10:].cpu().numpy() - truth[10:])
    stats = (float(np.median(tilt_dev)), float(np.percentile(tilt_dev, 95)), float(tilt_dev.max()))
    rms = float(torch.sqrt(torch.mean(view_errors**2)))
    print(f"[smoke] Scheimpflug intrinsics B={b} ({row}): tilt deviation median / p95 / max {stats!r} rad, mean "
          f"view RMS {rms!r} px, linearizations histogram {np.bincount(lm.linearizations.cpu().numpy()).tolist()}, "
          f"trials max {int(lm.iterations.max())}")
    check(bool(lm.success.all()), f"all {b} Scheimpflug lanes converged ({row})")
    check(all(v < g for v, g in zip(stats, TILT_GATES)), f"{row} tilt deviation median / p95 / max under {TILT_GATES}")
    check(SCHEIM_RMS_PX[0] <= rms <= SCHEIM_RMS_PX[1], f"{row} mean view RMS within {list(SCHEIM_RMS_PX)} px")
    if scheimpflug_opts(row).core.compute_covariance:
        check(bool(cov_ok.all()) and bool(torch.isfinite(cov).all()), f"{row}: every covariance finite")
    return stats


def scheimpflug_phase(dev, card, row):
    """Row 2S or 2T through intrinsics_batch with the Scheimpflug model on
    the card (phased, forward-mode Jacobians): the gates of
    ``check_scheimpflug``, first call and warm median, card/CPU on
    SCHEIM_PARITY_RIGS lanes (the same schedule: cost within 1e-7
    relative, the same iterations and termination). Returns the warm
    median in s."""
    tilt, _ = SCHEIM_ROWS[row]
    obj, uv, truth = scheimpflug_problems(SCHEIM_RIGS, tilt)
    opts = scheimpflug_opts(row)
    run = functools.partial(intrinsics_batch, torch.as_tensor(obj, device=dev), torch.as_tensor(uv, device=dev),
                            opts=opts, model_name=SCHEIM_NAME)
    zero_launches()
    (_, out), first_s = timed(run, dev)
    check_no_launches(f"row {row}")
    check_scheimpflug(out, truth, row)
    med, warm = warm_median(run, dev)
    print(f"[smoke] Scheimpflug intrinsics B={SCHEIM_RIGS} ({row}): first call {first_s!r} s, warm median {med!r} s "
          f"= {SCHEIM_RIGS / med!r} solves/s on {card} (warm calls {warm!r})")
    k = SCHEIM_PARITY_RIGS
    _, cpu = intrinsics_batch(torch.as_tensor(obj[:k]), torch.as_tensor(uv[:k]), opts=opts, model_name=SCHEIM_NAME,
                              two_phase=SCHEIM_RIGS >= batched.TWO_PHASE_MIN_BATCH)
    rel = float(((out[0].cost[:k].cpu() - cpu[0].cost).abs() / cpu[0].cost.abs()).max())
    same = all(torch.equal(getattr(out[0], f)[:k].cpu(), getattr(cpu[0], f)) for f in ("iterations", "termination"))
    print(f"[smoke] Scheimpflug ({row}) card vs CPU, first {k} lanes: final cost max rel diff {rel!r}, same "
          f"iterations and termination {same}")
    check(rel <= COST_PARITY_RTOL and same,
          f"{row} card/CPU parity: cost within {COST_PARITY_RTOL} relative, the same iterations and termination")
    return med


def timed_cell(run, dev):
    """(result, first call s, warm median s, warm calls): the first call,
    then ``warm_median``'s."""
    out, first_s = timed(run, dev)
    return (out, first_s) + warm_median(run, dev)


def lm_parity(card_lm, cpu_lm, what, counters=("iterations", "termination")):
    """Card vs CPU on the first lanes: final cost within COST_PARITY_RTOL
    relative and the same ``counters``; the lanes whose trials or
    termination differ are counted either way."""
    k = cpu_lm.cost.shape[0]
    rel = float(((card_lm.cost[:k].cpu() - cpu_lm.cost).abs() / cpu_lm.cost.abs()).max())
    same = all(torch.equal(getattr(card_lm, f)[:k].cpu(), getattr(cpu_lm, f)) for f in counters)
    moved = int(((card_lm.iterations[:k].cpu() != cpu_lm.iterations) |
                 (card_lm.termination[:k].cpu() != cpu_lm.termination)).sum())
    names = " and ".join(counters)
    print(f"[smoke] {what} card vs CPU, first {k} lanes: final cost max rel diff {rel!r}, same {names} {same}; "
          f"lanes with other trials or termination {moved}")
    check(rel <= COST_PARITY_RTOL and same,
          f"{what} card/CPU parity: cost within {COST_PARITY_RTOL} relative, the same {names}")


def planar_problems(cameras):
    """The planar-pose cell: every view of the bench.py set (cameras x 10
    views of the 8x11 grid, 0.2 px, seed 7; k3 = 0) as one problem, K at
    the truth. Returns (obj (B, 88, 2), uv, kmtx (B, 5), true poses
    (B, 4, 4)) with B = 10 x cameras."""
    obj, uv, intr = make_problems(cameras)
    n = obj.shape[-2]
    kmtx = np.tile(intr[:5], (cameras * obj.shape[1], 1))
    return obj.reshape(-1, n, 2), uv.reshape(-1, n, 2), kmtx, bench_poses(cameras).reshape(-1, 4, 4)


def planar_pose_phase(dev, card):
    """VarPro planar pose on the 2560 views of the bench.py set through
    planar_pose_batch on the card: every lane converged, each pose within
    PLANAR_TOL of the truth, the mean RMS at the 0.2 px noise, covariance
    finite, no K1 launch; first call and warm median; card/CPU on
    PLANAR_PARITY_LANES lanes. Returns the warm median in s."""
    obj, uv, kmtx, truth = planar_problems(PLANAR_CAMERAS)
    b = obj.shape[0]
    run = functools.partial(batched.planar_pose_batch, *(torch.as_tensor(a, device=dev) for a in (obj, uv, kmtx)),
                            options=PLANAR_OPTS)
    zero_launches()
    (lm, pose, coeffs, cov, cov_ok, rms), first_s, med, warm = timed_cell(run, dev)
    check_no_launches("planar pose")
    tra, rot = pose_errors(pose.cpu().numpy(), truth)
    mean_rms = float(rms.mean())
    print(f"[smoke] planar pose B={b}: pose vs truth max {tra!r} m, {rot!r} deg; mean RMS {mean_rms!r} px; "
          f"linearizations histogram {np.bincount(lm.linearizations.cpu().numpy()).tolist()}; trials max "
          f"{int(lm.iterations.max())}")
    check(bool(lm.success.all()), f"all {b} planar poses converged")
    check(tra <= PLANAR_TOL_M and rot <= PLANAR_TOL_DEG,
          f"every planar pose within {PLANAR_TOL_M} m and {PLANAR_TOL_DEG} deg of the truth")
    check(SCHEIM_RMS_PX[0] <= mean_rms <= SCHEIM_RMS_PX[1], f"planar pose mean RMS within {list(SCHEIM_RMS_PX)} px")
    check(bool(cov_ok.all()) and bool(torch.isfinite(cov).all()), "every planar-pose covariance finite")
    print(f"[smoke] planar pose B={b}: first call {first_s!r} s, warm median {med!r} s = {b / med!r} poses/s on "
          f"{card} (warm calls {warm!r})")
    k = PLANAR_PARITY_LANES
    cpu = batched.planar_pose_batch(*(torch.as_tensor(a[:k]) for a in (obj, uv, kmtx)), options=PLANAR_OPTS)
    lm_parity(lm, cpu[0], "planar pose", PLANAR_PARITY_COUNTERS)
    return med


def semidlt_solve(obj, uv):
    """The semi-DLT cell's solve: the Zhang seed's K (skew zeroed: it stays
    frozen), then optimize_intrinsics_semidlt_device."""
    kmtx = intrinsics_linear.estimate_intrinsics(obj, uv).kmtx.clone()
    kmtx[:, 4] = 0.0
    return optimize_intrinsics_semidlt_device(obj, uv, kmtx, opts=SEMIDLT_OPTS)


def semidlt_phase(dev, card):
    """Semi-DLT on the bench.py set's 256 cameras (k3 = 0) through
    optimize_intrinsics_semidlt_device on the card, seeded from
    estimate_intrinsics (skew zeroed, as it stays frozen): every camera
    converged, fx, fy, cx, cy within SEMIDLT_TOL_PX and k1, k2 within
    SEMIDLT_TOL_K of the truth, the mean view RMS at the noise, covariance
    finite, no K1 launch; first call and warm median; card/CPU on
    SEMIDLT_PARITY_CAMERAS cameras. Returns the warm median in s."""
    obj, uv, intr = make_problems(SEMIDLT_CAMERAS)
    run = functools.partial(semidlt_solve, torch.as_tensor(obj, device=dev), torch.as_tensor(uv, device=dev))
    zero_launches()
    out, first_s, med, warm = timed_cell(run, dev)
    check_no_launches("semi-DLT")
    lm, kmtx, coeffs, _, view_errors, cov, cov_ok, _ = out
    k_err = float((kmtx[:, :4].cpu() - torch.as_tensor(intr[:4])).abs().max())
    d_err = (coeffs[:, :2].cpu() - torch.as_tensor(intr[5:7])).abs().amax(dim=0).tolist()
    rms = float(torch.sqrt(torch.mean(view_errors**2)))
    print(f"[smoke] semi-DLT B={SEMIDLT_CAMERAS}: fx, fy, cx, cy vs truth max {k_err!r} px; k1, k2 max {d_err!r}; "
          f"mean view RMS {rms!r} px; linearizations histogram {np.bincount(lm.linearizations.cpu().numpy()).tolist()}"
          f"; trials max {int(lm.iterations.max())}")
    check(bool(lm.success.all()), f"all {SEMIDLT_CAMERAS} semi-DLT cameras converged")
    check(k_err <= SEMIDLT_TOL_PX, f"fx, fy, cx, cy within {SEMIDLT_TOL_PX} px of the truth on every camera")
    check(all(e <= t for e, t in zip(d_err, SEMIDLT_TOL_K)), f"k1, k2 within {SEMIDLT_TOL_K} of the truth")
    check(SCHEIM_RMS_PX[0] <= rms <= SCHEIM_RMS_PX[1], f"semi-DLT mean view RMS within {list(SCHEIM_RMS_PX)} px")
    check(bool(cov_ok.all()) and bool(torch.isfinite(cov).all()), "every semi-DLT covariance finite")
    print(f"[smoke] semi-DLT B={SEMIDLT_CAMERAS}: first call {first_s!r} s, warm median {med!r} s = "
          f"{SEMIDLT_CAMERAS / med!r} cameras/s on {card} (warm calls {warm!r})")
    k = SEMIDLT_PARITY_CAMERAS
    lm_parity(lm, semidlt_solve(torch.as_tensor(obj[:k]), torch.as_tensor(uv[:k]))[0], "semi-DLT")
    return med


def stereo_scheimpflug_phase(dev, card):
    """The config-3 stereo set through the Scheimpflug camera (SOLVER_TILT,
    p1 = p2 = 0) via extrinsics_batch(model_name=scheimpflug) on the card,
    the cameras fixed at the truth (phased, grouped forward-mode
    Jacobians): every rig converged, camera 1 within POSE_TOL of the truth,
    no K1 launch; first call and warm median; card/CPU on
    SOLVER_PARITY_RIGS rigs on the same schedule. Returns the warm median
    in s."""
    p = stereo_problems(STEREO_RIGS, tilt_tau=SOLVER_TILT)
    keys = ("obj", "uv", "intr0", "c0", "r0")
    run = functools.partial(extrinsics_batch, *(torch.as_tensor(p[k], device=dev) for k in keys),
                            opts=STEREO_SCHEIM_OPTS, model_name=SCHEIM_NAME)
    zero_launches()
    out, first_s, med, warm = timed_cell(run, dev)
    check_no_launches("the Scheimpflug stereo cell")
    check_stereo(out, p["rel_gt"])
    print(f"[smoke] Scheimpflug stereo B={STEREO_RIGS}: first call {first_s!r} s, warm median {med!r} s = "
          f"{STEREO_RIGS / med!r} rigs/s on {card} (warm calls {warm!r})")
    k = SOLVER_PARITY_RIGS
    cpu = extrinsics_batch(*(torch.as_tensor(p[key][:k]) for key in keys), opts=STEREO_SCHEIM_OPTS,
                           model_name=SCHEIM_NAME, two_phase=STEREO_RIGS >= batched.TWO_PHASE_MIN_BATCH)
    lm_parity(out[0], cpu[0], "Scheimpflug stereo")
    return med


def bundle_scheimpflug_phase(dev, card):
    """The config-5 set through the Scheimpflug camera (SOLVER_TILT,
    p1 = p2 = 0) via optimize_bundle_device(model=SCHEIMPFLUG) on the card,
    the intrinsics fixed (forward-mode Jacobians): every rig converged,
    g_se3_c within BUNDLE_TOL of the truth, no K1 launch; first call and
    warm median; card/CPU on SOLVER_PARITY_RIGS rigs. Returns the warm
    median in s."""
    p = bundle_problems(BUNDLE_RIGS, tilt_tau=SOLVER_TILT)
    run = functools.partial(optimize_bundle_device, *bundle_args(p, dev), model=SCHEIMPFLUG, opts=BUNDLE_OPTS)
    zero_launches()
    out, first_s, med, warm = timed_cell(run, dev)
    check_no_launches("the Scheimpflug bundle cell")
    check_bundle(out, p)
    print(f"[smoke] Scheimpflug bundle B={BUNDLE_RIGS}: first call {first_s!r} s, warm median {med!r} s = "
          f"{BUNDLE_RIGS / med!r} rigs/s on {card} (warm calls {warm!r})")
    k = SOLVER_PARITY_RIGS
    head = dict(p, **{key: p[key][:k] for key in ("obj", "uv", "bg", "g0", "b0")})
    lm_parity(out[0], optimize_bundle_device(*bundle_args(head, "cpu"), model=SCHEIMPFLUG, opts=BUNDLE_OPTS)[0],
              "Scheimpflug bundle")
    return med


def interleaved_medians(runs, dev, calls=WARM_CALLS):
    """{name: (median s, warm calls)} of ``calls`` rounds in which every
    run of ``runs`` ({name: fn}) is called once, in turn."""
    walls = {name: [] for name in runs}
    for _ in range(calls):
        for name, run in runs.items():
            walls[name].append(timed(run, dev)[1])
    return {name: (float(np.median(w)), w) for name, w in walls.items()}


def mesh_parity(got, want, what, counters=("iterations", "termination")):
    """A sharded call's LMOutput against the unsharded single-phase call's
    on the same card: final cost within MESH_COST_RTOL relative and the
    same ``counters`` (the card/CPU rule of the path)."""
    rel = float(((got.cost - want.cost).abs() / want.cost.abs()).max())
    same = all(torch.equal(getattr(got, f), getattr(want, f)) for f in counters)
    print(f"[smoke] {what} vs unsharded single phase: final cost max rel diff {rel!r}, same {' and '.join(counters)} "
          f"{same}")
    check(rel <= MESH_COST_RTOL and same,
          f"{what}: cost within {MESH_COST_RTOL} relative of the unsharded call, the same {' and '.join(counters)}")


def mesh_facade_cell(dev, card, mesh, b, what, calls):
    """Config 2's first ``b`` cameras through intrinsics_facade_batch on
    ``mesh``: every lane converged, the unpadded batch on the mesh's first
    device, one K1 launch per shard on the card, the gathered QA RMS
    within RMS_RTOL_F32 of plain float32 on the gathered solution, parity
    with the unsharded single-phase call, warm medians of both
    (``calls`` rounds). Returns the K1 launches of the first call."""
    obj, uv, intr_gt = make_problems(b)
    obj_d, uv_d = torch.as_tensor(obj, device=dev), torch.as_tensor(uv, device=dev)
    runs = {
        "sharded": functools.partial(intrinsics_facade_batch, obj_d, uv_d, opts=FACADE_OPTS, mesh=mesh),
        "unsharded": functools.partial(intrinsics_facade_batch, obj_d, uv_d, opts=FACADE_OPTS, two_phase=False),
    }
    zero_launches()
    (_, _, out, rms_check), first_s = timed(runs["sharded"], dev)
    launches = k1_launches()["rms"]
    lm = out[0]
    check(bool(lm.success.all()), f"{what}: all {b} lanes converged")
    check(out[1].shape == (b, 10) and out[1].device == mesh.devices[0] and rms_check.shape[0] == b,
          f"{what}: the outputs hold the unpadded batch on {mesh.devices[0]}")
    fx_err = float((out[1][:, 0] - intr_gt[0]).abs().mean())
    check(fx_err < 5.0, f"{what}: mean |fx - 600| < 5 px")
    if dev.type == "cuda":
        check(launches == mesh.size and k1_launches()["residuals"] == 0,
              f"{what}: one K1 launch in RMS mode per shard ({mesh.size})")
    ones = torch.ones(obj_d.shape[:3], dtype=obj_d.dtype, device=dev)
    plain = pr.projection_rms_plain(out[2], out[1], obj_d[:b], uv_d[:b], ones)
    rel = float(((rms_check - plain).abs() / plain.clamp(min=1e-30)).max())
    _, _, one, one_rms = runs["unsharded"]()
    to_one = float((rms_check.double() - one_rms.double()).abs().max())
    print(f"[smoke] {what}: gathered QA RMS max rel diff to plain f32 on the gathered solution {rel!r}, "
          f"max |sharded - unsharded QA RMS| {to_one!r} px")
    check(rel <= RMS_RTOL_F32, f"{what}: the gathered QA RMS within {RMS_RTOL_F32} relative of plain f32")
    mesh_parity(lm, one[0], what)
    med = interleaved_medians(runs, dev, calls)
    print(f"[smoke] {what} B={b} on {mesh.size} shard(s) ({', '.join(map(str, mesh.devices))}): K1 launches "
          f"{launches}, first call {first_s!r} s, warm median {med['sharded'][0]!r} s = {b / med['sharded'][0]!r} "
          f"solves/s; unsharded single phase {med['unsharded'][0]!r} s = {b / med['unsharded'][0]!r} solves/s, "
          f"sharded / unsharded {med['sharded'][0] / med['unsharded'][0]!r} on {card} (warm calls {med!r})")
    return launches


def mesh_phase(dev, card):
    """The ``mesh`` argument on the card: config 2 on a mesh of every
    visible card (B = 256) and on MESH_SHARDS shards of one card (B = 254,
    padded to 256), config 5 (B = 126) and planar pose (2558 views) on the
    4-shard mesh, each against the unsharded single-phase call on the same
    inputs. Returns the K1 launches of the two facade cells' first calls."""
    every = make_mesh() if dev.type == "cuda" else make_mesh([dev])
    launches = mesh_facade_cell(dev, card, every, FLEET, "config 2, every card", WARM_CALLS)
    if every.size >= 2:
        print(f"[smoke] config 2 over {every.size} cards: multi-card rate above")
    else:
        print("[smoke] one card visible: multi-card scaling not measured")
    shards = make_mesh([dev] * MESH_SHARDS)
    launches += mesh_facade_cell(dev, card, shards, MESH_FACADE_CAMERAS, "config 2, 4 shards of one card",
                                 MESH_WARM_CALLS)

    p = bundle_problems(MESH_BUNDLE_RIGS)
    args = bundle_args(p, dev)
    runs = {"sharded": functools.partial(bundle_batch, *args, opts=BUNDLE_OPTS, mesh=shards),
            "unsharded": functools.partial(bundle_batch, *args, opts=BUNDLE_OPTS, two_phase=False)}
    zero_launches()
    out, first_s = timed(runs["sharded"], dev)
    check_no_launches("config 5 on the mesh")
    check_bundle(out, p)
    check(out[2].device == shards.devices[0], "config 5 on the mesh: the outputs on the mesh's first device")
    mesh_parity(out[0], runs["unsharded"]()[0], "config 5, 4 shards")
    med = interleaved_medians(runs, dev, MESH_WARM_CALLS)
    print(f"[smoke] config 5 B={MESH_BUNDLE_RIGS} on {MESH_SHARDS} shards: first call {first_s!r} s, warm median "
          f"{med['sharded'][0]!r} s = {MESH_BUNDLE_RIGS / med['sharded'][0]!r} rigs/s; unsharded single phase "
          f"{med['unsharded'][0]!r} s, sharded / unsharded {med['sharded'][0] / med['unsharded'][0]!r} on {card}")

    obj, uv, kmtx, truth = (a[:MESH_PLANAR_VIEWS] for a in planar_problems(PLANAR_CAMERAS))
    tens = [torch.as_tensor(a, device=dev) for a in (obj, uv, kmtx)]
    runs = {"sharded": functools.partial(batched.planar_pose_batch, *tens, options=PLANAR_OPTS, mesh=shards),
            "unsharded": functools.partial(batched.planar_pose_batch, *tens, options=PLANAR_OPTS)}
    zero_launches()
    (lm, pose, *_), first_s = timed(runs["sharded"], dev)
    check_no_launches("planar pose on the mesh")
    tra, rot = pose_errors(pose.cpu().numpy(), truth)
    check(bool(lm.success.all()) and pose.shape[0] == MESH_PLANAR_VIEWS, "planar pose on the mesh: every lane converged")
    check(tra <= PLANAR_TOL_M and rot <= PLANAR_TOL_DEG, "planar pose on the mesh: every pose within PLANAR_TOL")
    one = runs["unsharded"]()[0]
    mesh_parity(lm, one, "planar pose, 4 shards", PLANAR_PARITY_COUNTERS)
    # one call with a thread per shard, as on a mesh of distinct cards: the
    # shards' dual-number Jacobians take turns under lm.FORWARD_AD_LOCK
    by_device = batched._by_device
    batched._by_device = lambda devices: [[i] for i in range(len(devices))]
    try:
        threaded, threaded_s = timed(runs["sharded"], dev)
    finally:
        batched._by_device = by_device
    mesh_parity(threaded[0], one, "planar pose, 4 shards on a thread each", PLANAR_PARITY_COUNTERS)
    med = interleaved_medians(runs, dev, MESH_WARM_CALLS)
    print(f"[smoke] planar pose B={MESH_PLANAR_VIEWS} on {MESH_SHARDS} shards: first call {first_s!r} s, warm median "
          f"{med['sharded'][0]!r} s = {MESH_PLANAR_VIEWS / med['sharded'][0]!r} poses/s; unsharded "
          f"{med['unsharded'][0]!r} s, sharded / unsharded {med['sharded'][0] / med['unsharded'][0]!r}; a thread per "
          f"shard (one call) {threaded_s!r} s on {card}")
    return launches


def mixed_phase(dev, card):
    """The precisions on the card: config 2 (MIXED_CAMERAS, phased,
    covariance on) through intrinsics_batch in "f64", "mixed" and
    "mixed_jac", and config 5 through optimize_bundle_device in "f64" and
    "mixed": every lane converged, each lane's final cost within
    MIXED_COST_RTOL of the f64 run's, the cells' truth bounds;
    WARM_CALLS interleaved warm calls of each, medians printed."""
    obj, uv, intr_gt = make_problems(MIXED_CAMERAS)
    obj_d, uv_d = torch.as_tensor(obj, device=dev), torch.as_tensor(uv, device=dev)
    runs = {p: functools.partial(intrinsics_batch, obj_d, uv_d, opts=FACADE_OPTS, precision=p)
            for p in ("f64", "mixed", "mixed_jac")}
    p5 = bundle_problems(BUNDLE_RIGS)
    args5 = bundle_args(p5, dev)
    runs5 = {p: functools.partial(optimize_bundle_device, *args5, opts=BUNDLE_OPTS, precision=p)
             for p in ("f64", "mixed")}
    zero_launches()
    outs = {p: timed(run, dev) for p, run in runs.items()}
    outs5 = {p: timed(run, dev) for p, run in runs5.items()}
    check_no_launches("the mixed precisions")
    for p, ((_, out), first_s) in outs.items():
        lm, intr, _, view_errors = out[:4]
        rel = float(((lm.cost - outs["f64"][0][1][0].cost).abs() / outs["f64"][0][1][0].cost).max())
        rms = float(torch.sqrt(torch.mean(view_errors**2)))
        fx_err = float((intr[:, 0] - intr_gt[0]).abs().mean())
        print(f"[smoke] config 2 B={MIXED_CAMERAS} precision {p}: first call {first_s!r} s, final cost max rel diff "
              f"to f64 {rel!r}, mean view RMS {rms!r} px, mean |fx - 600| {fx_err!r} px, linearizations max "
              f"{int(lm.linearizations.max())}")
        check(bool(lm.success.all()), f"config 2 ({p}): all lanes converged")
        check(rel <= MIXED_COST_RTOL, f"config 2 ({p}): final cost within {MIXED_COST_RTOL} of f64 on every lane")
        check(0.15 <= rms <= 0.25 and fx_err < 5.0, f"config 2 ({p}): RMS in [0.15, 0.25] px, mean |fx - 600| < 5 px")
    for p, (out, first_s) in outs5.items():
        rel = float(((out[0].cost - outs5["f64"][0][0].cost).abs() / outs5["f64"][0][0].cost).max())
        print(f"[smoke] config 5 B={BUNDLE_RIGS} precision {p}: first call {first_s!r} s, final cost max rel diff to "
              f"f64 {rel!r}")
        check_bundle(out, p5)
        check(rel <= MIXED_COST_RTOL, f"config 5 ({p}): final cost within {MIXED_COST_RTOL} of f64 on every rig")
    for cell, b, r in (("config 2", MIXED_CAMERAS, runs), ("config 5", BUNDLE_RIGS, runs5)):
        med = interleaved_medians(r, dev)
        print(f"[smoke] {cell} B={b} warm medians by precision on {card}: "
              + ", ".join(f"{p} {m!r} s ({b / m!r}/s)" for p, (m, _) in med.items()) + f" (warm calls {med!r})")


def homography_lm(obj, uv, options):
    """Config 1's dense LM from its float64 DLT seed, single phase, both
    ways: (``lm_cost_trace`` -> (LMOutput, costs (B, max_iterations)),
    ``optimize_homography_device``'s ``lm_core`` -> LMOutput), each a
    function of no arguments on the same inputs."""
    mask, block_ids, n, _ = homography_opt._problem(obj, None)
    init_h = batched._homog_seed(obj, uv, mask, "f64")

    def trace():
        return lm_cost_trace(
            homography_opt._residual, homography_opt.h_to_params(init_h), homography_opt._MANIFOLD,
            data=(obj, uv, mask), options=options, block_ids=block_ids, num_blocks=n,
        )

    def core():
        return homography_opt.optimize_homography_device(init_h, obj, uv, mask, options=options)[0]

    return trace, core


def trace_phase(dev, card):
    """lm_cost_trace on config 1 (HOMOG_LANES, HOMOG_OPTS, single phase):
    its output equal to lm_core's (x, cost, counters), the cost at the last
    linearization the final cost, no curve rising; the median curve and
    the trace's cost against the plain solve. Then one warm config-2
    facade call under device_trace: the trace file names K1's kernel."""
    _, src, dst = homography_problems(HOMOG_LANES)
    runs = dict(zip(("trace", "lm_core"), homography_lm(
        torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev), HOMOG_OPTS)))
    (out, costs), first_s = timed(runs["trace"], dev)
    core = runs["lm_core"]()
    same = all(torch.equal(getattr(out, f), getattr(core, f)) for f in out._fields)
    lin = out.linearizations
    last = costs.gather(1, (lin - 1).clamp(min=0)[:, None])[:, 0]
    rises = int((costs[:, 1:] > costs[:, :-1]).any(dim=1).sum())
    curve = costs[:, : int(lin.max())].median(dim=0).values.tolist()
    print(f"[smoke] cost trace config 1 B={HOMOG_LANES}: equal to lm_core's output {same}, linearizations max "
          f"{int(lin.max())}, lanes whose curve rises {rises}; median curve {curve!r}")
    check(same, "the trace's output equals lm_core's (x, cost, every counter)")
    check(torch.equal(last, out.cost), "the cost at each lane's last linearization is its final cost")
    check(rises == 0, "no lane's cost curve rises")
    med = interleaved_medians(runs, dev)
    print(f"[smoke] cost trace config 1: first call {first_s!r} s; warm medians lm_cost_trace {med['trace'][0]!r} s, "
          f"lm_core {med['lm_core'][0]!r} s, trace / lm_core {med['trace'][0] / med['lm_core'][0]!r} on {card} "
          f"(warm calls {med!r})")

    obj, uv, _ = make_problems(FLEET)
    obj_d, uv_d = torch.as_tensor(obj, device=dev), torch.as_tensor(uv, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            intrinsics_facade_batch(obj_d, uv_d, opts=FACADE_OPTS)
        files = list(Path(tmp).glob("trace_*.json"))
        text = files[0].read_text() if len(files) == 1 else ""
    print(f"[smoke] device_trace of one facade call: {len(files)} file(s), {len(text)} bytes, names K1's kernel "
          f"{'projection_kernel' in text}")
    check(len(files) == 1, "device_trace writes one Chrome trace")
    if dev.type == "cuda":
        check("projection_kernel" in text, "the facade call's trace names K1's kernel (projection_kernel)")


def linescan_app_inputs(directory, views=6):
    """The linescan_calibration app's inputs: the committed example, a
    RANSAC variant of it, and a Scheimpflug input written from row 5S's
    generator (its first rig, ``views`` views, no junk pixels). Returns
    {name: path}."""
    base = json.loads((Path(__file__).resolve().parent / "examples/data/linescan_input.json").read_text())
    ransac_in = dict(base, plane_fit={"method": "ransac", "ransac": dict(LINESCAN_RANSAC_OPTS, thresh=0.005)})
    camera, obj, tuv, luv, _ = linescan_problems(1, views=views, seed=LINESCAN_SEEDS["5S"], tilt_tau=LINESCAN_TILT)
    k = camera[0]
    scheim_in = {
        "camera": {"kmtx": dict(zip(("fx", "fy", "cx", "cy", "skew"), k[:5].tolist())),
                   "distortion": {"coeffs": k[5:10].tolist()}, "model": "scheimpflug",
                   "tilt": {"taux": float(k[10]), "tauy": float(k[11])}},
        "views": [{"target_view": [{"object_xy": o.tolist(), "image_uv": u.tolist()} for o, u in zip(obj[0, v], tuv[0, v])],
                   "laser_uv": luv[0, v].tolist()} for v in range(views)],
    }
    paths = {}
    for name, payload in (("example", base), ("ransac", ransac_in), ("scheimpflug", scheim_in)):
        paths[name] = Path(directory) / f"linescan_{name}.json"
        paths[name].write_text(json.dumps(payload))
    return paths


def run_linescan_app(input_path, out, device):
    """One linescan_calibration call: (artifact JSON, wall s)."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        t0 = time.perf_counter()
        rc = linescan_calibration.main(["--input", str(input_path), "--output", str(out), "--device", device])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        print(log.getvalue()[-4000:])
    check(rc == 0, f"the linescan_calibration app exits 0 on {device} ({Path(input_path).name})")
    return json.loads(Path(out).read_text()), wall


def linescan_app_phase(card, device="cuda"):
    """The linescan_calibration app on ``device`` on each of
    ``linescan_app_inputs``: exit 0, no K1 launch, the artifact equal to the
    CPU app's within the report bounds."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_helpers import assert_reports_match

    with tempfile.TemporaryDirectory() as tmp:
        for name, path in linescan_app_inputs(tmp).items():
            zero_launches()
            art, wall = run_linescan_app(path, Path(tmp) / f"{name}_{device}.out", device)
            check_no_launches(f"the linescan app ({name})")
            cpu, _ = run_linescan_app(path, Path(tmp) / f"{name}_cpu.out", "cpu")
            assert_reports_match(cpu, art)
            print(f"[smoke] linescan app ({name}) on {card}: {wall!r} s, plane n {art['plane']['n']!r} d "
                  f"{art['plane']['d']!r} ({art['plane']['method']}, {art['plane']['inliers']} inliers); the CPU "
                  f"app's artifact within the report bounds")


_K1_ZERO = {"residuals": 0, "rms": 0}  # the counts at the last zero_launches()


def k1_launches() -> dict:
    """K1's launches by mode since the last ``zero_launches()``, from the
    program's counter store (``k1.launches.<mode>``)."""
    c = profiling.counters()
    return {mode: c.get(f"k1.launches.{mode}", 0) - zero for mode, zero in _K1_ZERO.items()}


def zero_launches() -> None:
    c = profiling.counters()
    for mode in _K1_ZERO:
        _K1_ZERO[mode] = c.get(f"k1.launches.{mode}", 0)


def ransac_rounds(device_type: str) -> int:
    """RANSAC rounds run so far on ``device_type`` (``ransac.rounds.<type>``)."""
    return profiling.counters().get(f"ransac.rounds.{device_type}", 0)


def start_ptxas_report() -> subprocess.Popen:
    """nvcc with -Xptxas -v on K1's source (a cubin into a temporary
    directory), started beside the library build: registers and spills of
    every instantiation."""
    tmp = tempfile.mkdtemp()
    src = _build.CSRC_DIR / "projection_residuals.cu"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [_build._nvcc(), *flags, "-Xptxas", "-v", "-cubin", "-o", str(Path(tmp) / "k1.cubin"), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def print_ptxas_report(proc: subprocess.Popen) -> None:
    text, _ = proc.communicate(timeout=600)
    check(proc.returncode == 0, "nvcc -Xptxas -v compiles K1's source")
    for line in text.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[smoke] ptxas: {line.strip()}")


def qa_kernel_count(c_se3_t, intrs, obj_xy, img_uv, mask):
    """Device kernels one reprojection_rms_batch call runs, by name, as
    torch.profiler reads them; None when the profiler shows no device
    activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        batched.reprojection_rms_batch(c_se3_t, intrs, obj_xy, img_uv, mask)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if (getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)) > 0}
    return kernels or None


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    # the QA path's f32 matmuls run in full f32, never TF32; the solve is f64
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    print(f"[smoke] card (name, power limit): {card}")

    t0 = time.perf_counter()
    ptxas = start_ptxas_report()
    lib = _build.build()
    _build.load_library()
    print(f"[smoke] built {lib} in {time.perf_counter() - t0!r} s")
    print_ptxas_report(ptxas)

    max_err = kernel_phase(dev)

    # the main path, once, with the launch counts read around it
    b = 256
    obj, uv, intr_gt = make_problems(b)
    obj_d = torch.as_tensor(obj, device=dev)
    uv_d = torch.as_tensor(uv, device=dev)
    opts = FACADE_OPTS
    zero_launches()
    t0 = time.perf_counter()
    _, _, out, rms_check = intrinsics_facade_batch(obj_d, uv_d, opts=opts)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    facade_launches = k1_launches()
    lm_out, intr, poses, view_errors, cov, cov_ok = out
    n_ok = int(lm_out.success.sum())
    rms = float(torch.sqrt(torch.mean(view_errors**2)))
    fx_err = float((intr[:, 0] - intr_gt[0]).abs().mean())
    qa_warn = int(((rms_check.double() - view_errors).abs() > QA_ATOL_PX).sum())
    print(f"[smoke] facade B={b}: {n_ok}/{b} lanes converged, mean view RMS {rms!r} px, "
          f"mean |fx - 600| {fx_err!r} px, linearizations max {int(lm_out.linearizations.max())}, "
          f"QA warnings {qa_warn}, K1 launches {facade_launches}, first call {cold_s!r} s")
    check(n_ok == b, f"all {b} lanes converged")
    check(0.15 <= rms <= 0.25, "mean view RMS within [0.15, 0.25] px")
    check(fx_err < 5.0, "mean |fx - 600| < 5 px")
    check(bool(cov_ok.all()) and bool(torch.isfinite(cov).all()), "every covariance finite")
    check(qa_warn == 0, f"QA recheck within {QA_ATOL_PX} px of view_errors for every view")
    check(facade_launches == {"residuals": 0, "rms": 1}, "the facade's QA recheck is one K1 launch in RMS mode")

    t0 = time.perf_counter()
    intrinsics_facade_batch(obj_d, uv_d, opts=opts)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"[smoke] facade B={b} warm call: {warm_s!r} s = {b / warm_s!r} solves/s on {card}")

    # the public residual op, as a user calls it, on the facade's solved
    # fleet; its RMS must be the QA recheck's
    zero_launches()
    ones = torch.ones(obj_d.shape[:3], dtype=obj_d.dtype, device=dev)
    rows = qa_rows(poses, intr, obj_d, uv_d, ones)
    res = pr.projection_residuals_f32(*rows)
    torch.cuda.synchronize()
    residual_launches = k1_launches()["residuals"]
    diff = float((pr._rms_from_residuals(res, rows[5]).reshape(rms_check.shape) - rms_check).abs().max())
    print(f"[smoke] residual op on the solved fleet: {tuple(res.shape)}, K1 launches {k1_launches()}, "
          f"max |RMS of its residuals - QA recheck| {diff!r} px")
    check(residual_launches == 1 and k1_launches()["rms"] == 0, "the residual op is one K1 launch in residual mode")
    check(diff <= KERNEL_ATOL_PX, f"the residual op's RMS within {KERNEL_ATOL_PX} px of the QA recheck")

    k = 8
    _, _, out_cpu, _ = intrinsics_facade_batch(
        torch.as_tensor(obj[:k]), torch.as_tensor(uv[:k]), opts=opts, two_phase=True
    )
    cost_cpu = out_cpu[0].cost
    cost_gpu = lm_out.cost[:k].cpu()
    rel = float(((cost_gpu - cost_cpu).abs() / cost_cpu.abs()).max())
    print(f"[smoke] card vs CPU final cost, first {k} problems: max rel diff {rel!r}")
    check(rel <= COST_PARITY_RTOL, f"card/CPU cost parity within {COST_PARITY_RTOL} relative")

    rms_launches = facade_launches["rms"] + app_phase(card)
    stereo_phase(dev, card)
    rms_launches += pipeline_phase(card)
    homography_phase(dev, card)
    handeye_phase(dev, card)
    bundle_phase(dev, card)
    rms_launches += handeye_pipeline_phase(card)
    linescan_phase(dev, card)
    linescan_ransac_phase(dev, card, "5R")
    linescan_ransac_phase(dev, card, "5S")
    scheimpflug_phase(dev, card, "2S")
    scheimpflug_phase(dev, card, "2T")
    linescan_app_phase(card)
    planar_pose_phase(dev, card)
    semidlt_phase(dev, card)
    stereo_scheimpflug_phase(dev, card)
    bundle_scheimpflug_phase(dev, card)
    rms_launches += mesh_phase(dev, card)
    mixed_phase(dev, card)
    trace_phase(dev, card)
    print(f"[smoke] end-to-end phases done {time.perf_counter() - start!r} s after the start")

    # last, so that the profiler's device tracing (CUPTI) is off during the
    # end-to-end phases above
    timing = {(b, v, n): timing_phase(dev, b, v, n) for b, v, n in QA_SHAPES[:2]}
    kernels = qa_kernel_count(poses, intr, obj_d, uv_d, ones)
    print(f"[smoke] device kernels of one reprojection_rms_batch call (profiler): {kernels}")
    if kernels is not None:
        check(sum(kernels.values()) == 1 and "projection_kernel" in next(iter(kernels)),
              "reprojection_rms_batch runs one device kernel, K1, and copies nothing")

    source = "calibration_tpu_torch/csrc/projection_residuals.cu"
    facade_shape = timing[QA_SHAPES[0]]
    records = []
    for mode, name, replaces, launches in (
        ("residuals", "projection_residuals", "calibration_tpu/ops/pallas_kernels.py:40", residual_launches),
        ("rms", "projection_rms", "calibration_tpu/ops/pallas_kernels.py:40, calibration_tpu/parallel/batched.py:734",
         rms_launches),
    ):
        t = facade_shape[mode]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err[mode],
            "ms": t["ms"], "ms_warm": t["ms_warm"], "kernel_ms": t["kernel_ms"], "host_ms": t["host_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,  # no single PyTorch call computes this function
            "shape": f"{QA_SHAPES[0][0] * QA_SHAPES[0][1]}x{QA_SHAPES[0][2]}",
        })
    print(f"[smoke] whole run {time.perf_counter() - start!r} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
