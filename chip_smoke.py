#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires a CUDA device (exits non-zero without one) and prints the
   card's name and power limit.
2. Builds the CUDA kernels of ``calibration_tpu_torch/csrc`` with nvcc.
3. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shape and at a ragged one, and times both (CUDA events).
4. Drives the main path once: ``intrinsics_facade_batch`` on the bench.py
   problem set (B = 256 cameras, 10 views of an 8x11 grid, noise 0.2 px,
   seed 7, max_iterations 40, epsilon 1e-9, covariance on), checks the
   result and that the kernel was launched, then times a second call.
5. Solves the first 8 problems again on the CPU and holds the final costs
   against the card's within 1e-7 relative.
6. Drives the planar_intrinsics app (``--fleet --device cuda``) on the same
   problem set written as 256 detections files, with 4 of the 88 points of
   every view displaced by 20-40 px and the RANSAC prefilter on: a first and
   a warm call, each timed by layer (ingest, prefilter, solve, QA kernel,
   report writing). It checks the reports (every displaced point rejected
   and every clean point kept, every camera converged, mean RMS in
   [0.15, 0.25] px, no QA warning), that the kernel and the prefilter ran
   on the card, and card/CPU parity of the app on the first 8 sensors.

Earlier lines report each phase; the line before the last is the kernels
JSON record, and the last line is the device JSON record. Any failed check
exits non-zero. The script imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from calibration_tpu_torch import native
from calibration_tpu_torch.apps import planar_intrinsics
from calibration_tpu_torch.kernels import _build
from calibration_tpu_torch.models import pinhole
from calibration_tpu_torch.ops import projection_residuals as pr
from calibration_tpu_torch.ops import ransac
from calibration_tpu_torch.optim import IntrinsicsOptimOptions, OptimOptions
from calibration_tpu_torch.parallel import batched, intrinsics_facade_batch
from calibration_tpu_torch.pipeline import loaders, reports
from calibration_tpu_torch.pipeline.facades import intrinsics as facade_mod

KERNEL_ATOL_PX = 5e-3  # f32 rounding of ~640 px values; the JAX kernel's gate
QA_ATOL_PX = 5e-3  # the facade's rms_check warning threshold
COST_PARITY_RTOL = 1e-7  # card vs CPU final robust cost
CAMERA_PARITY_RTOL = 1e-6  # card vs CPU refined camera, app reports
FLEET = 256  # sensors of the app phase
OUTLIERS = 4  # displaced points per view, 20-40 px
PARITY_SENSORS = 8


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


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` on the card over ``reps`` calls, after warm-up."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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


def residual_inputs(r, n, seed):
    """Random rows of the kernel's inputs (the JAX kernel tests' recipe)."""
    rng = np.random.default_rng(seed)
    intr = np.tile(np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.15, 0.05, 0.0, 1e-4, -2e-4]), (r, 1))
    intr[:, 0] += rng.normal(0, 5, r)
    rot = _exp_so3(rng.normal(0, 0.2, (r, 3)))
    tra = rng.normal(0, 0.05, (r, 3)) + [0, 0, 1.0]
    obj = rng.uniform(-0.15, 0.15, (r, n, 2))
    uv = rng.uniform(0, 640, (r, n, 2))
    mask = rng.uniform(size=(r, n)) > 0.2
    return rot, tra, intr, obj, uv, mask


def kernel_phase(dev):
    """Kernel vs plain at the main-path shape and a ragged shape."""
    worst = 0.0
    timing = None
    for r, n, seed in ((2560, 88, 11), (19, 150, 5)):
        arrays = residual_inputs(r, n, seed)
        f32 = [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in arrays]
        f64 = [torch.as_tensor(a, dtype=torch.float64, device=dev) for a in arrays]
        got = pr.projection_residuals_f32(*f32)
        torch.cuda.synchronize()
        ref64 = pr.projection_residuals_plain(*f64)
        ref32 = pr.projection_residuals_plain(*f32)
        err64 = float((got.double() - ref64).abs().max())
        err32 = float((got - ref32).abs().max())
        masked = ~f32[5].bool()
        print(f"[smoke] kernel {r}x{n}: max|kernel - plain f64| = {err64!r} px, "
              f"max|kernel - plain f32| = {err32!r} px")
        check(err64 <= KERNEL_ATOL_PX, f"kernel {r}x{n} within {KERNEL_ATOL_PX} px of plain f64")
        check(bool((got[masked] == 0).all()), f"kernel {r}x{n} masked entries are exactly 0")
        worst = max(worst, err64)
        if timing is None:
            ms = cuda_ms(lambda: pr.projection_residuals_f32(*f32), 200)
            plain_ms = cuda_ms(lambda: pr.projection_residuals_plain(*f32), 200)
            print(f"[smoke] kernel {r}x{n}: {ms!r} ms/launch, plain f32 {plain_ms!r} ms/call")
            timing = (ms, plain_ms)
    return worst, timing


def make_problems(batch, views=10, rows=8, cols=11, noise=0.2, seed=7):
    """The bench.py problem set (its make_problems), projected through the
    port's pinhole model on the CPU in float64."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    ys, xs = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    obj = np.stack([xs.ravel() * 0.03, ys.ravel() * 0.03], -1)
    obj = obj - obj.mean(0)
    intr = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.15, 0.05, 0.0, 1e-4, -2e-4])
    ang = 2 * np.pi * np.arange(views)[None, :] / views + 0.05 * np.arange(batch)[:, None]
    w = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.1 * np.sin(2 * ang)], axis=-1)
    t = np.stack([0.06 * np.cos(ang), 0.06 * np.sin(ang), 0.9 + 0.08 * np.sin(ang)], axis=-1)
    poses = np.zeros((batch, views, 4, 4))
    poses[..., :3, :3] = _exp_so3(w)
    poses[..., :3, 3] = t
    poses[..., 3, 3] = 1.0
    obj3 = np.concatenate([obj, np.zeros((n, 1))], -1)
    pts_c = np.einsum("bvij,nj->bvni", poses[:, :, :3, :3], obj3) + poses[:, :, None, :3, 3]
    uv = pinhole.project(torch.as_tensor(intr), torch.as_tensor(pts_c)).numpy()
    uv = uv + rng.normal(0, noise, uv.shape)
    return np.tile(obj[None, None], (batch, views, 1, 1)), uv, intr


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


@contextlib.contextmanager
def layer_timers(device: str):
    """Wall time by layer inside the app, each layer closed by a
    synchronize on the card: yields a Counter of seconds filled in as the
    app runs; the wrapped functions are restored on exit."""
    seconds = collections.Counter()
    targets = (
        (loaders, "read_detections", "ingest"),
        (facade_mod.PlanarIntrinsicCalibrationFacade, "_prefilter", "prefilter"),
        (facade_mod, "intrinsics_facade_batch", "solve"),
        (batched, "reprojection_rms_batch", "qa_kernel"),
        (reports, "build_planar_intrinsics_report", "report"),
        (native, "dumps_fast", "report"),
    )
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
    with layer_timers(device) as seconds, contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
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
            pr.launches = 0
            rounds = ransac.rounds["cuda"]
            report, wall, seconds = run_app(config, features, Path(tmp) / f"report_{call}.json", "cuda")
            rounds = ransac.rounds["cuda"] - rounds
            if launches is None:
                launches = pr.launches  # the path's one counted run; the warm call repeats it
            layers = ", ".join(f"{k} {v!r} s" for k, v in sorted(seconds.items()))
            print(f"[smoke] app {call} call: {wall!r} s = {FLEET / wall!r} sensors/s on {card}; {layers}; "
                  f"other {wall - sum(seconds.values())!r} s; kernel launches {pr.launches}, "
                  f"prefilter rounds on the card {rounds}")
            check_fleet_report(report, displaced)
            check(pr.launches > 0, "the app launched the projection-residual kernel")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    # the QA path's f32 matmuls run in full f32, never TF32; the solve is f64
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    print(f"[smoke] card (name, power limit): {card}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"[smoke] built {lib} in {time.perf_counter() - t0!r} s")

    max_err, (ms, plain_ms) = kernel_phase(dev)

    # the main path, once, with the launch count read around it
    b = 256
    obj, uv, intr_gt = make_problems(b)
    obj_d = torch.as_tensor(obj, device=dev)
    uv_d = torch.as_tensor(uv, device=dev)
    opts = IntrinsicsOptimOptions(
        core=OptimOptions(max_iterations=40, epsilon=1e-9, compute_covariance=True)
    )
    pr.launches = 0
    t0 = time.perf_counter()
    _, _, out, rms_check = intrinsics_facade_batch(obj_d, uv_d, opts=opts)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = pr.launches
    lm_out, intr, _, view_errors, cov, cov_ok = out
    n_ok = int(lm_out.success.sum())
    rms = float(torch.sqrt(torch.mean(view_errors**2)))
    fx_err = float((intr[:, 0] - intr_gt[0]).abs().mean())
    qa_warn = int(((rms_check.double() - view_errors).abs() > QA_ATOL_PX).sum())
    print(f"[smoke] facade B={b}: {n_ok}/{b} lanes converged, mean view RMS {rms!r} px, "
          f"mean |fx - 600| {fx_err!r} px, linearizations max {int(lm_out.linearizations.max())}, "
          f"QA warnings {qa_warn}, kernel launches {launches}, first call {cold_s!r} s")
    check(n_ok == b, f"all {b} lanes converged")
    check(0.15 <= rms <= 0.25, "mean view RMS within [0.15, 0.25] px")
    check(fx_err < 5.0, "mean |fx - 600| < 5 px")
    check(bool(cov_ok.all()) and bool(torch.isfinite(cov).all()), "every covariance finite")
    check(qa_warn == 0, f"QA recheck within {QA_ATOL_PX} px of view_errors for every view")
    check(launches > 0, "the facade launched the projection-residual kernel")

    t0 = time.perf_counter()
    intrinsics_facade_batch(obj_d, uv_d, opts=opts)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"[smoke] facade B={b} warm call: {warm_s!r} s = {b / warm_s!r} solves/s on {card}")

    k = 8
    _, _, out_cpu, _ = intrinsics_facade_batch(
        torch.as_tensor(obj[:k]), torch.as_tensor(uv[:k]), opts=opts, two_phase=True
    )
    cost_cpu = out_cpu[0].cost
    cost_gpu = lm_out.cost[:k].cpu()
    rel = float(((cost_gpu - cost_cpu).abs() / cost_cpu.abs()).max())
    print(f"[smoke] card vs CPU final cost, first {k} problems: max rel diff {rel!r}")
    check(rel <= COST_PARITY_RTOL, f"card/CPU cost parity within {COST_PARITY_RTOL} relative")

    launches += app_phase(card)

    print(json.dumps({"kernels": [{
        "name": "projection_residuals_f32",
        "route": "cuda",
        "source": "calibration_tpu_torch/csrc/projection_residuals.cu",
        "replaces": "calibration_tpu/ops/pallas_kernels.py:40",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
