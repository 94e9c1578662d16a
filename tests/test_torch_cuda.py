"""Card-only tests of the PyTorch port: the CUDA projection-residual kernel
in both modes (residuals, per-view RMS) against its plain versions, the facade on the card against the same facade
on the CPU, the batched RANSAC prefilter on the card, the
planar_intrinsics app on the card against the app on the CPU, the
extrinsics batch on the card against the CPU, the
intrinsic_extrinsic_pipeline app on the card against the app on the CPU,
the dense LM's users (homography_batch, handeye_batch, bundle_batch,
the dense intrinsics solver, the homography and the four-stage
bundle_pipeline apps) on the card against the CPU, and the line-scan slice
(linescan_batch, linescan_ransac_batch, the linescan_calibration app),
the Scheimpflug intrinsics_batch, and the variable-projection and
any-model solvers (the distortion fits, the linear intrinsics,
planar_pose_batch, optimize_planar_pose, semi-DLT, the Scheimpflug
extrinsics in each Jacobian mode and the Scheimpflug bundle) on the card
against the CPU; a mesh of two shards on one card against the unsharded
call (and K1 launched once per shard), and the "mixed" precision's float32
phase on the card; the dense LM's CUDA graphs against its eager
solves (bundle_batch in one phase and two, handeye_batch, lm_cost_trace)
and the solves that stay eager; the Schur LM's CUDA graphs against its
eager solves (the intrinsics facade with its padded second phase,
"mixed_jac", the stereo rig), the Scheimpflug solve that stays eager, a
planted capture failure, and ``spd_inverse`` inside a CUDA graph.
Every test here is marked ``cuda`` and skips without a CUDA device. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from calibration_tpu_torch.apps import bundle_pipeline, homography as homography_app
from calibration_tpu_torch.apps import intrinsic_extrinsic_pipeline, linescan_calibration, planar_intrinsics
from calibration_tpu_torch.models import distortion, pinhole
from calibration_tpu_torch.models.registry import SCHEIMPFLUG
from calibration_tpu_torch.ops import projection_residuals as pr
from calibration_tpu_torch.ops import intrinsics_linear, linalg, ransac, se3
from calibration_tpu_torch.optim import BundleOptions, ExtrinsicOptions, IntrinsicsOptimOptions, OptimOptions
from calibration_tpu_torch.optim import intrinsics as toi
from calibration_tpu_torch.optim import blocks
from calibration_tpu_torch.optim import bundle as bundle_mod
from calibration_tpu_torch.optim import lm, lm_graphs, lm_schur
from calibration_tpu_torch.optim.manifold import ProductManifold, euclid
from calibration_tpu_torch.optim import optimize_bundle_device, optimize_extrinsics_device, optimize_planar_pose
from calibration_tpu_torch.optim import optimize_intrinsics_semidlt, optimize_intrinsics_semidlt_device
from calibration_tpu_torch.parallel import bundle_batch, extrinsics_batch, handeye_batch, homography_batch
from calibration_tpu_torch.parallel import intrinsics_batch, intrinsics_facade_batch, linescan_batch
from calibration_tpu_torch.parallel import batched, linescan_ransac_batch, make_mesh, planar_pose_batch
from calibration_tpu_torch.utils import profiling
from torch_helpers import assert_reports_match, k1_launches, ransac_rounds

pytestmark = pytest.mark.cuda

ATOL_PX = 5e-3  # f32 rounding of ~640 px values (the JAX kernel's gate)
CAMERA = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.15, 0.05, 0.0, 1e-4, -2e-4])


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(r, n, seed):
    rng = np.random.default_rng(seed)
    intr = np.tile(CAMERA, (r, 1))
    intr[:, 0] += rng.normal(0, 5, r)
    rot = se3.exp_so3(torch.as_tensor(rng.normal(0, 0.2, (r, 3)))).numpy()
    tra = rng.normal(0, 0.05, (r, 3)) + [0, 0, 1.0]
    obj = rng.uniform(-0.15, 0.15, (r, n, 2))
    uv = rng.uniform(0, 640, (r, n, 2))
    mask = rng.uniform(size=(r, n)) > 0.2
    return rot, tra, intr, obj, uv, mask


@pytest.mark.parametrize("r,n,seed", [(5, 37, 2), (19, 150, 5), (2560, 88, 11), (70000, 3, 1)])
def test_kernel_matches_plain(cuda_device, r, n, seed):
    arrays = _rows(r, n, seed)
    before = k1_launches()["residuals"]
    got = pr.projection_residuals_f32(*(torch.as_tensor(a, device=cuda_device) for a in arrays))
    torch.cuda.synchronize()
    assert k1_launches()["residuals"] == before + 1
    ref = pr.projection_residuals_plain(
        *(torch.as_tensor(a, dtype=torch.float64, device=cuda_device) for a in arrays)
    )
    assert float((got.double() - ref).abs().max()) <= ATOL_PX
    assert bool((got[~torch.as_tensor(arrays[5], device=cuda_device)] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,v,n,seed", [(256, 10, 88, 11), (19, 1, 150, 5)])
def test_rms_mode_matches_plain(cuda_device, b, v, n, seed, dtype):
    """One RMS-mode launch per call: within ATOL_PX of plain float64, within
    1e-5 relative of plain float32 (only the summation order differs), 0 on
    an all-masked view, the same bits on a second launch."""
    rot, tra, intr, obj, uv, mask = _rows(b * v, n, seed)
    mask[3] = False
    poses = np.tile(np.eye(4), (b * v, 1, 1))
    poses[:, :3, :3], poses[:, :3, 3] = rot, tra
    args = [poses.reshape(b, v, 4, 4), intr[::v].copy(), obj.reshape(b, v, n, 2), uv.reshape(b, v, n, 2),
            mask.reshape(b, v, n)]
    card = [torch.as_tensor(a, dtype=dtype if a.dtype != bool else None, device=cuda_device) for a in args]
    before = k1_launches()["rms"]
    got = pr.projection_rms_f32(*card)
    again = pr.projection_rms_f32(*card)
    torch.cuda.synchronize()
    assert k1_launches()["rms"] == before + 2 and got.dtype == torch.float32 and got.shape == (b, v)
    plain64 = _rms_plain_f64(*(torch.as_tensor(a, device=cuda_device) for a in args))
    plain32 = pr.projection_rms_plain(*card)
    assert float((got.double() - plain64).abs().max()) <= ATOL_PX
    assert float(((got - plain32).abs() / plain32.clamp(min=1e-30)).max()) <= 1e-5
    assert float(got.reshape(-1)[3]) == 0.0
    assert torch.equal(got, again)


def _rms_plain_f64(c_se3_t, intrs, obj, uv, mask):
    """The RMS in exact float64: the plain residuals of the f64 rows."""
    b, v, n = obj.shape[:3]
    res = pr.projection_residuals_plain(
        c_se3_t[..., :3, :3].reshape(-1, 3, 3), c_se3_t[..., :3, 3].reshape(-1, 3),
        intrs[:, None].expand(b, v, 10).reshape(-1, 10), obj.reshape(-1, n, 2), uv.reshape(-1, n, 2),
        mask.reshape(-1, n),
    )
    return pr._rms_from_residuals(res, mask.reshape(-1, n)).reshape(b, v)


def test_facade_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(3)
    b, v = 8, 6
    ang = 2 * np.pi * np.arange(v)[None, :] / v + 0.05 * np.arange(b)[:, None]
    w = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.1 * np.sin(2 * ang)], -1)
    t = np.stack([0.06 * np.cos(ang), 0.06 * np.sin(ang), 0.9 + 0.08 * np.sin(ang)], -1)
    ys, xs = np.meshgrid(np.arange(5), np.arange(7), indexing="ij")
    grid = np.stack([xs.ravel() * 0.04, ys.ravel() * 0.04], -1)
    grid = grid - grid.mean(0)
    rot = se3.exp_so3(torch.as_tensor(w))
    pts = torch.as_tensor(np.concatenate([grid, np.zeros((len(grid), 1))], -1))
    pc = torch.einsum("bvij,nj->bvni", rot, pts) + torch.as_tensor(t)[:, :, None, :]
    uv = pinhole.project(torch.as_tensor(CAMERA), pc) + torch.as_tensor(rng.normal(0, 0.2, pc.shape[:-1] + (2,)))
    obj = torch.as_tensor(np.broadcast_to(grid, (b, v) + grid.shape).copy())
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=40, epsilon=1e-9))

    before = k1_launches()
    _, _, out_gpu, rms_gpu = intrinsics_facade_batch(
        obj.to(cuda_device), uv.to(cuda_device), opts=opts, two_phase=True
    )
    torch.cuda.synchronize()
    assert k1_launches() == dict(before, rms=before["rms"] + 1)  # the QA recheck: one RMS launch
    _, _, out_cpu, rms_cpu = intrinsics_facade_batch(obj, uv, opts=opts, two_phase=True)
    assert bool(out_gpu[0].success.all())
    assert torch.equal(out_gpu[0].linearizations.cpu(), out_cpu[0].linearizations)
    rel = ((out_gpu[0].cost.cpu() - out_cpu[0].cost).abs() / out_cpu[0].cost).max()
    assert float(rel) <= 1e-7
    assert float((rms_gpu.cpu() - rms_cpu).abs().max()) <= ATOL_PX


def test_prefilter_on_card_recovers_planted_outliers(cuda_device):
    """Pure pinhole views of an 8x11 grid, 0.2 px noise, 6 points per view
    moved by 30-80 px, 2 views with a masked tail: the card's prefilter
    keeps exactly the clean valid points, as the CPU's does."""
    rng = np.random.default_rng(4)
    v = 24
    ys, xs = np.meshgrid(np.arange(8), np.arange(11), indexing="ij")
    grid = np.stack([xs.ravel() * 0.03, ys.ravel() * 0.03], -1)
    grid = grid - grid.mean(0)
    ang = 2 * np.pi * np.arange(v) / v
    w = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.1 * np.sin(2 * ang)], -1)
    t = np.stack([0.06 * np.cos(ang), 0.06 * np.sin(ang), 0.9 + 0.08 * np.sin(ang)], -1)
    pts = torch.as_tensor(np.concatenate([grid, np.zeros((len(grid), 1))], -1))
    pc = torch.einsum("vij,nj->vni", se3.exp_so3(torch.as_tensor(w)), pts) + torch.as_tensor(t)[:, None, :]
    cam = torch.as_tensor(np.concatenate([CAMERA[:5], np.zeros(5)]))
    uv = (pinhole.project(cam, pc) + torch.as_tensor(rng.normal(0, 0.2, pc.shape[:-1] + (2,)))).numpy()
    n = grid.shape[0]
    planted = np.zeros((v, n), bool)
    for i in range(v):
        bad = rng.choice(n, 6, replace=False)
        uv[i, bad] += rng.uniform(30, 80, (6, 2)) * rng.choice([-1, 1], (6, 2))
        planted[i, bad] = True
    mask = np.ones((v, n), bool)
    mask[:2, -10:] = False
    obj = np.broadcast_to(grid, (v, n, 2)).copy()
    opts = ransac.RansacOptions()
    before = ransac_rounds("cuda")
    got = ransac.ransac_homography(
        *(torch.as_tensor(a, device=cuda_device) for a in (obj, uv)), opts,
        mask=torch.as_tensor(mask, device=cuda_device),
    )
    torch.cuda.synchronize()
    assert ransac_rounds("cuda") > before
    assert bool(got.success.all())
    np.testing.assert_array_equal(got.inlier_mask.cpu().numpy(), mask & ~planted)
    cpu = ransac.ransac_homography(torch.as_tensor(obj), torch.as_tensor(uv), opts, mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(got.inlier_mask.cpu().numpy(), cpu.inlier_mask.numpy())


def test_app_on_card_matches_cpu(cuda_device, tmp_path):
    """--fleet on examples/data with --device cuda gives the --device cpu
    report within the port's report bounds (torch_helpers.report_tolerance)."""
    reports = []
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.json"
        before = k1_launches()["rms"]
        argv = [
            "--fleet", "--device", device, "--config", "examples/data/planar_intrinsics_config.json",
            "--features", "examples/data/detections_cam0.json", "examples/data/detections_cam1.json",
            "-o", str(out),
        ]
        assert planar_intrinsics.main(argv) == 0
        if device == "cuda":
            assert k1_launches()["rms"] == before + 1  # the QA recheck ran the kernel
        reports.append(json.loads(out.read_text()))
    assert_reports_match(reports[1], reports[0])


@pytest.mark.parametrize("covariance", [False, True], ids=["phased", "single_phase_covariance"])
def test_extrinsics_batch_on_card_matches_cpu(cuda_device, covariance):
    """8 rigs of the config-3 set, phased (boundaries forced) or in one
    phase with covariance: the same counters, cost within 1e-7 relative,
    covariance within 1e-6 of its largest entry."""
    p = chip_smoke.stereo_problems(8)
    opts = ExtrinsicOptions(core=OptimOptions(max_iterations=50, compute_covariance=covariance))
    keys = ("obj", "uv", "intr0", "c0", "r0")
    gpu = extrinsics_batch(*(torch.as_tensor(p[k], device=cuda_device) for k in keys), opts=opts, two_phase=True)
    cpu = extrinsics_batch(*(torch.as_tensor(p[k]) for k in keys), opts=opts, two_phase=True)
    assert bool(gpu[0].success.all())
    assert torch.equal(gpu[0].linearizations.cpu(), cpu[0].linearizations)
    assert torch.equal(gpu[0].iterations.cpu(), cpu[0].iterations)
    assert float(((gpu[0].cost.cpu() - cpu[0].cost).abs() / cpu[0].cost).max()) <= 1e-7
    if covariance:
        assert bool(gpu[5].all())
        scale = cpu[4].abs().amax(dim=(-2, -1))
        assert bool(((gpu[4].cpu() - cpu[4]).abs().amax(dim=(-2, -1)) <= 1e-6 * scale).all())


def test_pipeline_app_on_card_matches_cpu(cuda_device, tmp_path):
    """examples/data/pipeline_input.json with --device cuda gives the
    --device cpu artifacts within the report bounds; the intrinsics stage
    ran the kernel."""
    arts = []
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.json"
        before = k1_launches()["rms"]
        argv = ["--input", "examples/data/pipeline_input.json", "--output", str(out), "--device", device]
        assert intrinsic_extrinsic_pipeline.main(argv) == 0
        if device == "cuda":
            assert k1_launches()["rms"] > before
        arts.append(chip_smoke.without_durations(json.loads(out.read_text())))
    assert_reports_match(arts[1], arts[0])


def _lm_equal(gpu, cpu, cost_rtol=1e-7):
    assert torch.equal(gpu.linearizations.cpu(), cpu.linearizations)
    assert torch.equal(gpu.iterations.cpu(), cpu.iterations)
    assert float(((gpu.cost.cpu() - cpu.cost).abs() / cpu.cost.abs().clamp(min=1e-300)).max()) <= cost_rtol


@pytest.mark.parametrize("two_phase", [False, True], ids=["one_phase", "phased"])
def test_homography_batch_on_card_matches_cpu(cuda_device, two_phase):
    """96 lanes of the config-1 set, covariance on: the same counters, cost
    1e-7 relative, H 1e-9, covariance 1e-6 of its largest entry."""
    _, src, dst = chip_smoke.homography_problems(96)
    opts = OptimOptions(max_iterations=50)
    gpu = homography_batch(torch.as_tensor(src, device=cuda_device), torch.as_tensor(dst, device=cuda_device),
                           options=opts, two_phase=two_phase)
    cpu = homography_batch(torch.as_tensor(src), torch.as_tensor(dst), options=opts, two_phase=two_phase)
    assert bool(gpu[0].success.all()) and bool(gpu[3].all())
    _lm_equal(gpu[0], cpu[0])
    assert float((gpu[1].cpu() - cpu[1]).abs().max()) <= 1e-9
    scale = cpu[2].abs().amax(dim=(-2, -1))
    assert bool(((gpu[2].cpu() - cpu[2]).abs().amax(dim=(-2, -1)) <= 1e-6 * scale).all())


@pytest.mark.parametrize("rot_residual", ["quat", "log"])
def test_handeye_batch_on_card_matches_cpu(cuda_device, rot_residual):
    """16 rigs of the config-4 set with 2 mm camera noise, covariance on."""
    _, bg, ct = chip_smoke.handeye_problems(16)
    ct = ct.copy()
    ct[..., :3, 3] += np.random.default_rng(1).normal(0, 2e-3, ct[..., :3, 3].shape)
    opts = OptimOptions(max_iterations=50)
    gpu = handeye_batch(torch.as_tensor(bg, device=cuda_device), torch.as_tensor(ct, device=cuda_device),
                        options=opts, rot_residual=rot_residual)
    cpu = handeye_batch(torch.as_tensor(bg), torch.as_tensor(ct), options=opts, rot_residual=rot_residual)
    assert bool(gpu[0].success.all())
    _lm_equal(gpu[0], cpu[0])
    assert float((gpu[1].cpu() - cpu[1]).abs().max()) <= 1e-9
    scale = cpu[2].abs().amax(dim=(-2, -1))
    assert bool(((gpu[2].cpu() - cpu[2]).abs().amax(dim=(-2, -1)) <= 1e-6 * scale).all())


def test_dense_intrinsics_on_card_matches_cpu(cuda_device):
    """The dense engine with forward-mode Jacobians over a quaternion
    manifold (solver="dense"), 4 cameras, covariance on."""
    obj, uv, intr = chip_smoke.make_problems(4, views=6)
    ang = 2 * np.pi * np.arange(6)[None, :] / 6 + 0.05 * np.arange(4)[:, None]
    w = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.1 * np.sin(2 * ang)], axis=-1)
    t = np.stack([0.06 * np.cos(ang), 0.06 * np.sin(ang), 0.9 + 0.08 * np.sin(ang)], axis=-1)
    poses = np.tile(np.eye(4), (4, 6, 1, 1))
    poses[..., :3, :3], poses[..., :3, 3] = chip_smoke._exp_so3(w), t
    intr0 = np.tile(intr, (4, 1))
    intr0[:, :4] += [8.0, -6.0, 4.0, -3.0]
    intr0[:, 5:] = 0.0
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=40))
    args = (obj, uv, intr0, poses)
    gpu = toi.optimize_intrinsics_device(*(torch.as_tensor(a, device=cuda_device) for a in args), opts=opts,
                                         solver="dense")
    cpu = toi.optimize_intrinsics_device(*(torch.as_tensor(a) for a in args), opts=opts, solver="dense")
    assert bool(gpu[0].success.all()) and bool(gpu[5].all())
    _lm_equal(gpu[0], cpu[0])
    assert float(((gpu[1].cpu() - cpu[1]).abs() / cpu[1].abs().clamp(min=1e-3)).max()) <= 1e-6


def test_homography_app_on_card_matches_cpu(cuda_device, tmp_path):
    outs = []
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.json"
        argv = ["--input", "examples/data/homography_input.json", "-o", str(out), "--device", device]
        assert homography_app.main(argv) == 0
        outs.append(json.loads(out.read_text()))
    gpu, cpu = outs
    assert gpu["estimated"]["inliers"] == cpu["estimated"]["inliers"]
    assert np.abs(np.array(gpu["optimized"]["homography"]) - np.array(cpu["optimized"]["homography"])).max() <= 1e-9
    assert abs(gpu["optimized"]["core"]["final_cost"] / cpu["optimized"]["core"]["final_cost"] - 1) <= 1e-7


def test_bundle_pipeline_app_on_card_matches_cpu(cuda_device, tmp_path):
    """The four-stage pipeline (intrinsics, hand-eye, bundle) on 3
    generated robot cells: the card's artifacts are the CPU's within the
    report bounds and the intrinsics stage ran the kernel."""
    fleet = chip_smoke.write_handeye_fleet(tmp_path, 3)
    arts = []
    for device in ("cuda", "cpu"):
        out = tmp_path / f"{device}.json"
        before = k1_launches()["rms"]
        assert bundle_pipeline.main(["--input", fleet["input_path"], "--output", str(out), "--device", device]) == 0
        if device == "cuda":
            assert k1_launches()["rms"] > before
        arts.append(chip_smoke.without_durations(json.loads(out.read_text())))
    assert [s["name"] for s in arts[0]["pipeline_summary"]["stages"]] == ["intrinsics", "hand_eye", "bundle"]
    assert_reports_match(arts[1], arts[0])


@pytest.mark.parametrize("two_phase,covariance", [(False, True), (True, False)], ids=["one_phase_cov", "phased"])
def test_bundle_batch_on_card_matches_cpu(cuda_device, two_phase, covariance):
    """16 lanes of the config-5 set: the same counters, cost 1e-7
    relative, g_se3_c 1e-9, covariance 1e-6 of its largest entry."""
    p = chip_smoke.bundle_problems(16)
    opts = BundleOptions(core=OptimOptions(max_iterations=50, compute_covariance=covariance))
    gpu = bundle_batch(*chip_smoke.bundle_args(p, cuda_device), opts=opts, two_phase=two_phase)
    cpu = bundle_batch(*chip_smoke.bundle_args(p, "cpu"), opts=opts, two_phase=two_phase)
    assert bool(gpu[0].success.all()) and bool(gpu[5].all()) == covariance
    _lm_equal(gpu[0], cpu[0])
    assert float((gpu[2].cpu() - cpu[2]).abs().max()) <= 1e-9
    scale = cpu[4].abs().amax(dim=(-2, -1)).clamp(min=1e-300)
    assert bool(((gpu[4].cpu() - cpu[4]).abs().amax(dim=(-2, -1)) <= 1e-6 * scale).all())


@pytest.mark.parametrize("model", [chip_smoke.PINHOLE_NAME, chip_smoke.SCHEIM_NAME])
def test_linescan_batch_on_card_matches_cpu(cuda_device, model):
    """16 rigs of row 5L's set (or row 5S's camera): planes, homographies and
    RMS within 1e-9, the same point counts and ok; no K1 launch."""
    tilt = chip_smoke.LINESCAN_TILT if model == chip_smoke.SCHEIM_NAME else None
    p = chip_smoke.linescan_problems(16, tilt_tau=tilt)
    before = k1_launches()
    gpu = linescan_batch(*(torch.as_tensor(a, device=cuda_device) for a in p[:4]), model_name=model)
    cpu = linescan_batch(*(torch.as_tensor(a) for a in p[:4]), model_name=model)
    assert k1_launches() == before and bool(gpu.ok.all())
    for name in ("plane", "homography", "rms_error"):
        assert float((getattr(gpu, name).cpu() - getattr(cpu, name)).abs().max()) <= 1e-9, name
    assert torch.equal(gpu.inlier_count.cpu(), cpu.inlier_count) and torch.equal(gpu.ok.cpu(), cpu.ok)


@pytest.mark.parametrize("row", ["5R", "5S"])
def test_linescan_ransac_batch_on_card_matches_cpu(cuda_device, row):
    """16 rigs of row 5R's or 5S's set with their junk pixels: the card and
    the CPU draw the same noise, so inlier counts, ok and (within 1e-9)
    planes agree lane for lane; the rounds ran on the card."""
    tilt = chip_smoke.LINESCAN_TILT if row == "5S" else None
    model = chip_smoke.SCHEIM_NAME if tilt else chip_smoke.PINHOLE_NAME
    camera, obj, tuv, luv, _ = chip_smoke.linescan_ransac_problems(row, tilt)
    args = [a[:16] for a in (camera, obj, tuv, luv)]
    opts = ransac.RansacOptions(**chip_smoke.LINESCAN_RANSAC_OPTS)
    rounds = ransac_rounds("cuda")
    gpu = linescan_ransac_batch(*(torch.as_tensor(a, device=cuda_device) for a in args), options=opts,
                                model_name=model)
    assert ransac_rounds("cuda") > rounds
    cpu = linescan_ransac_batch(*(torch.as_tensor(a) for a in args), options=opts, model_name=model)
    assert bool(gpu.ok.all())
    assert torch.equal(gpu.inlier_count.cpu(), cpu.inlier_count) and torch.equal(gpu.ok.cpu(), cpu.ok)
    assert float((gpu.plane.cpu() - cpu.plane).abs().max()) <= 1e-9


@pytest.mark.parametrize("row", ["2S", "2T"])
def test_scheimpflug_intrinsics_batch_on_card_matches_cpu(cuda_device, row):
    """8 lanes of row 2S's (covariance on) or 2T's set, phased: the same
    counters, cost 1e-7 relative, covariance 1e-6 of its largest entry; no
    K1 launch."""
    tilt, _ = chip_smoke.SCHEIM_ROWS[row]
    obj, uv, _ = chip_smoke.scheimpflug_problems(8, tilt)
    opts = chip_smoke.scheimpflug_opts(row)
    before = k1_launches()
    _, gpu = intrinsics_batch(torch.as_tensor(obj, device=cuda_device), torch.as_tensor(uv, device=cuda_device),
                              opts=opts, model_name=chip_smoke.SCHEIM_NAME, two_phase=True)
    _, cpu = intrinsics_batch(torch.as_tensor(obj), torch.as_tensor(uv), opts=opts,
                              model_name=chip_smoke.SCHEIM_NAME, two_phase=True)
    assert k1_launches() == before and bool(gpu[0].success.all())
    _lm_equal(gpu[0], cpu[0])
    if opts.core.compute_covariance:
        scale = cpu[4].abs().amax(dim=(-2, -1))
        assert bool(((gpu[4].cpu() - cpu[4]).abs().amax(dim=(-2, -1)) <= 1e-6 * scale).all())


def test_linescan_app_on_card_matches_cpu(cuda_device, tmp_path):
    """The linescan_calibration app with --device cuda on the committed
    example, its RANSAC variant and a Scheimpflug input: exit 0 and the
    --device cpu artifact within the report bounds."""
    for name, path in chip_smoke.linescan_app_inputs(tmp_path).items():
        arts = []
        for device in ("cuda", "cpu"):
            out = tmp_path / f"{name}_{device}.json"
            assert linescan_calibration.main(["--input", str(path), "--output", str(out), "--device", device]) == 0
            arts.append(json.loads(out.read_text()))
        assert_reports_match(arts[1], arts[0])


def test_distortion_fits_and_linear_intrinsics_on_card_match_cpu(cuda_device):
    """On 16 views of the bench.py set: the masked distortion fit, its dual
    and the inverse within 1e-9 of the CPU; the linear intrinsics and their
    iteration within 1e-9 relative, the same ok."""
    obj, uv, kmtx, poses = chip_smoke.planar_problems(2)
    pts = np.concatenate([obj, np.zeros(obj.shape[:-1] + (1,))], -1)
    pc = np.einsum("bij,bnj->bni", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    xy = pc[..., :2] / pc[..., 2:]
    mask = np.ones(xy.shape[:-1], bool)
    mask[:, ::9] = False
    args = (xy[:16], uv[:16], kmtx[:16])
    for fn, kw in ((distortion.fit_distortion_full, {"mask": mask[:16]}), (distortion.fit_distortion_dual, {})):
        gpu = fn(*(torch.as_tensor(a, device=cuda_device) for a in args), 2,
                 **{k: torch.as_tensor(v, device=cuda_device) for k, v in kw.items()})
        cpu = fn(*(torch.as_tensor(a) for a in args), 2, **{k: torch.as_tensor(v) for k, v in kw.items()})
        for g, c in zip(gpu, cpu):
            assert float((g.cpu().double() - c.double()).abs().max()) <= 1e-9 * max(1.0, float(c.double().abs().max()))
    coeffs = torch.tensor(chip_smoke.make_problems(1)[2][[5, 6, 8, 9]])
    assert float((distortion.invert_brown_conrady(coeffs.to(cuda_device)).cpu() - distortion.invert_brown_conrady(
        coeffs)).abs().max()) <= 1e-9
    for fn in (intrinsics_linear.estimate_intrinsics_linear, intrinsics_linear.estimate_intrinsics_linear_iterative):
        gpu = fn(*(torch.as_tensor(a, device=cuda_device) for a in args[:2]))
        cpu = fn(*(torch.as_tensor(a) for a in args[:2]))
        assert torch.equal(gpu[-1].cpu(), cpu[-1])
        for g, c in zip(gpu[:-1], cpu[:-1]):
            assert float(((g.cpu() - c).abs() / c.abs().clamp(min=1.0)).max()) <= 1e-9


def test_planar_pose_on_card_matches_cpu(cuda_device):
    """32 views of the planar-pose cell through planar_pose_batch, and one
    through optimize_planar_pose: the same linearizations and success (the
    trials at the minimum are decided by roundoff: chip_smoke's
    PLANAR_PARITY_COUNTERS), cost 1e-7 relative, poses 1e-9, covariance
    1e-6 of its largest entry; no K1 launch."""
    obj, uv, kmtx, _ = chip_smoke.planar_problems(4)
    args = [a[:32] for a in (obj, uv, kmtx)]
    before = k1_launches()
    gpu = planar_pose_batch(*(torch.as_tensor(a, device=cuda_device) for a in args))
    cpu = planar_pose_batch(*(torch.as_tensor(a) for a in args))
    assert k1_launches() == before and bool(gpu[0].success.all())
    for name in chip_smoke.PLANAR_PARITY_COUNTERS:
        assert torch.equal(getattr(gpu[0], name).cpu(), getattr(cpu[0], name)), name
    assert float(((gpu[0].cost.cpu() - cpu[0].cost).abs() / cpu[0].cost).max()) <= 1e-7
    assert float((gpu[1].cpu() - cpu[1]).abs().max()) <= 1e-9
    scale = cpu[3].abs().amax(dim=(-2, -1))
    assert bool(((gpu[3].cpu() - cpu[3]).abs().amax(dim=(-2, -1)) <= 1e-6 * scale).all())
    one = [torch.as_tensor(a[0]) for a in args]
    host = [optimize_planar_pose(*(t.to(d) for t in one), init_pose=cpu[1][0].to(d)) for d in (cuda_device, "cpu")]
    assert host[0].core.success and host[1].core.success
    np.testing.assert_allclose(host[0].core.final_cost, host[1].core.final_cost, rtol=1e-7)


def test_semidlt_on_card_matches_cpu(cuda_device):
    """4 cameras of the semi-DLT cell through the device function, one
    through the host wrapper: the same counters, cost 1e-7 relative, K
    1e-9 relative, covariance 1e-6 of its largest entry."""
    obj, uv, _ = chip_smoke.make_problems(4)

    def solve(dev):
        o, u = torch.as_tensor(obj, device=dev), torch.as_tensor(uv, device=dev)
        kmtx = intrinsics_linear.estimate_intrinsics(o, u).kmtx.clone()
        kmtx[:, 4] = 0.0
        return optimize_intrinsics_semidlt_device(o, u, kmtx, opts=chip_smoke.SEMIDLT_OPTS), (o, u, kmtx)

    (gpu, g_in), (cpu, c_in) = solve(cuda_device), solve("cpu")
    assert bool(gpu[0].success.all())
    _lm_equal(gpu[0], cpu[0])
    assert float(((gpu[1].cpu() - cpu[1]).abs() / cpu[1].abs().clamp(min=1.0)).max()) <= 1e-9
    scale = cpu[5].abs().amax(dim=(-2, -1))
    assert bool(((gpu[5].cpu() - cpu[5]).abs().amax(dim=(-2, -1)) <= 1e-6 * scale).all())
    host = [optimize_intrinsics_semidlt(*(t[0] for t in ins), opts=chip_smoke.SEMIDLT_OPTS) for ins in (g_in, c_in)]
    assert host[0].core.iterations == host[1].core.iterations
    np.testing.assert_allclose(host[0].core.final_cost, host[1].core.final_cost, rtol=1e-7)


@pytest.mark.parametrize("solver,jac_mode", [("schur", "grouped"), ("schur", "full"), ("dense", "grouped")])
def test_scheimpflug_extrinsics_on_card_matches_cpu(cuda_device, solver, jac_mode):
    """8 rigs of the Scheimpflug stereo cell (the cameras fixed, as the
    smoke solves it) with covariance on, in each Jacobian mode and the
    dense solver: the same counters, cost 1e-7 relative, covariance 1e-6
    of its largest entry; no K1 launch."""
    p = chip_smoke.stereo_problems(8, tilt_tau=chip_smoke.SOLVER_TILT)
    keys = ("obj", "uv", "intr0", "c0", "r0")
    opts = ExtrinsicOptions(core=OptimOptions(max_iterations=50), optimize_intrinsics=False)
    before = k1_launches()
    gpu, cpu = (optimize_extrinsics_device(*(torch.as_tensor(p[k], device=d) for k in keys), model=SCHEIMPFLUG,
                                           opts=opts, solver=solver, jac_mode=jac_mode) for d in (cuda_device, "cpu"))
    assert k1_launches() == before and bool(gpu[0].success.all())
    _lm_equal(gpu[0], cpu[0])
    scale = cpu[4].abs().amax(dim=(-2, -1))
    assert bool(((gpu[4].cpu() - cpu[4]).abs().amax(dim=(-2, -1)) <= 1e-6 * scale).all())


def test_scheimpflug_extrinsics_batch_and_bundle_on_card_match_cpu(cuda_device):
    """8 rigs each of the Scheimpflug stereo cell through extrinsics_batch
    (phased, as the smoke runs it) and of the Scheimpflug bundle cell
    through optimize_bundle_device (covariance on): the same counters,
    cost 1e-7 relative."""
    p = chip_smoke.stereo_problems(8, tilt_tau=chip_smoke.SOLVER_TILT)
    keys = ("obj", "uv", "intr0", "c0", "r0")
    gpu, cpu = (extrinsics_batch(*(torch.as_tensor(p[k], device=d) for k in keys), opts=chip_smoke.STEREO_SCHEIM_OPTS,
                                 model_name=chip_smoke.SCHEIM_NAME, two_phase=True) for d in (cuda_device, "cpu"))
    assert bool(gpu[0].success.all())
    _lm_equal(gpu[0], cpu[0])
    q = chip_smoke.bundle_problems(8, tilt_tau=chip_smoke.SOLVER_TILT)
    opts = BundleOptions(core=OptimOptions(max_iterations=50))
    gpu, cpu = (optimize_bundle_device(*chip_smoke.bundle_args(q, d), model=SCHEIMPFLUG, opts=opts)
                for d in (cuda_device, "cpu"))
    assert bool(gpu[0].success.all()) and bool(gpu[5].all())
    _lm_equal(gpu[0], cpu[0])


def _facade_set(device, b=7):
    obj, uv, _ = chip_smoke.make_problems(b)
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=40, compute_covariance=True))
    return torch.as_tensor(obj, device=device), torch.as_tensor(uv, device=device), opts


def test_two_shard_mesh_of_one_card_gives_the_unsharded_result(cuda_device):
    """7 cameras padded to 8, two shards on cuda:0: the unsharded
    single-phase result, gathered on cuda:0."""
    obj, uv, opts = _facade_set(cuda_device)
    mesh = make_mesh([cuda_device] * 2)
    _, _, got, rms = intrinsics_facade_batch(obj, uv, opts=opts, mesh=mesh)
    _, _, want, rms_one = intrinsics_facade_batch(obj, uv, opts=opts, two_phase=False)
    assert got[1].shape == (7, 10) and got[1].device == mesh.devices[0]
    for name in ("iterations", "linearizations", "termination", "success"):
        assert torch.equal(getattr(got[0], name), getattr(want[0], name)), name
    torch.testing.assert_close(got[0].cost, want[0].cost, rtol=1e-10, atol=0)
    torch.testing.assert_close(rms, rms_one, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_sharded_facade_launches_k1_once_per_shard(cuda_device, shards):
    obj, uv, opts = _facade_set(cuda_device)
    before = k1_launches()
    intrinsics_facade_batch(obj, uv, opts=opts, mesh=make_mesh([cuda_device] * shards))
    torch.cuda.synchronize()
    assert k1_launches() == {"residuals": before["residuals"], "rms": before["rms"] + shards}


def test_mixed_runs_its_coarse_phase_in_float32_on_card(cuda_device, monkeypatch):
    """The first Schur LM of "mixed" runs on float32 card tensors; the
    polish ends within 1e-8 of the float64 solve's cost."""
    obj, uv, opts = _facade_set(cuda_device, b=4)
    seen = []
    real = lm_schur.lm_core_schur

    def spy(res, jac, xg0, *args, **kwargs):
        seen.append((xg0.dtype, xg0.device.type))
        return real(res, jac, xg0, *args, **kwargs)

    monkeypatch.setattr(lm_schur, "lm_core_schur", spy)
    _, mixed = intrinsics_batch(obj, uv, opts=opts, precision="mixed", two_phase=False)
    assert seen == [(torch.float32, "cuda"), (torch.float64, "cuda")]
    _, f64 = intrinsics_batch(obj, uv, opts=opts, two_phase=False)
    assert bool(mixed[0].success.all())
    torch.testing.assert_close(mixed[0].cost, f64[0].cost, rtol=1e-8, atol=0)


def test_a_fresh_process_may_start_on_a_mesh(cuda_device):
    """The first linalg call of a process on a card loads PyTorch's CUDA
    linear-algebra kernels, which is not thread-safe: a process whose first
    solve is a mesh of four shards, each on its own thread as on distinct
    cards, must not race it."""
    code = (
        "import torch, chip_smoke\n"
        "from calibration_tpu_torch.parallel import batched, intrinsics_facade_batch, make_mesh\n"
        "batched._by_device = lambda devices: [[i] for i in range(len(devices))]\n"
        "obj, uv, _ = chip_smoke.make_problems(8, views=4, rows=5, cols=7)\n"
        "out = intrinsics_facade_batch(torch.as_tensor(obj, device='cuda'), torch.as_tensor(uv, device='cuda'),\n"
        "                              opts=chip_smoke.FACADE_OPTS, mesh=make_mesh(['cuda:0'] * 4))\n"
        "assert bool(out[2][0].success.all())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]



def test_k1_launches_fall_inside_k1_rms_spans(cuda_device, tmp_path):
    """A batch-256 facade call traced by ``torch.profiler`` (device
    activity) with the program's spans on: through the tracer's clock
    anchor, every ``cudaLaunchKernel`` of K1 lies inside a ``k1.rms`` span,
    to within 50 us."""
    obj, uv, opts = _facade_set(cuda_device, b=256)
    intrinsics_facade_batch(obj, uv, opts=opts)
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with profiling.tracing() as handle, torch.profiler.profile(activities=[act.CUDA]) as prof:
        for _ in range(2):
            intrinsics_facade_batch(obj, uv, opts=opts)
        torch.cuda.synchronize()
    drained = handle.drain()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = trace["traceEvents"]
    k1 = {e["args"]["correlation"] for e in events
          if e.get("cat") == "kernel" and "projection_kernel" in e.get("name", "")}
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaLaunchKernel"
                and e.get("args", {}).get("correlation") in k1]
    spans = [((profiling.unix_ns(s.start_ns, drained.anchor) - base) / 1e3,
              (profiling.unix_ns(s.end_ns, drained.anchor) - base) / 1e3)
             for s in drained.spans if s.name == "k1.rms"]
    assert len(spans) == 2 and len(launches) == 2
    for e in launches:
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        assert any(a - 50.0 <= start and end <= b + 50.0 for a, b in spans), (start, end, spans)


def _graph_counts(prefix="dense"):
    c = profiling.counters()
    return {k: c.get(f"{prefix}.graph.{k}", 0) for k in ("captures", "replays", "eager")}


def _thrice(solve, prefix="dense"):
    """``solve()`` three times from empty graph caches: eagerly (a key's
    first sighting), capturing (its second), replaying; returns the three
    outputs and the ``<prefix>.graph`` counters' steps of each call."""
    lm_graphs.clear()
    outs, steps = [], []
    for _ in range(3):
        before = _graph_counts(prefix)
        outs.append(solve())
        torch.cuda.synchronize()
        after = _graph_counts(prefix)
        steps.append({k: after[k] - before[k] for k in after})
    return outs, steps


def _same_trajectory(graphed, eager):
    """iterations, linearizations and termination equal; x, cost and the
    initial cost to 1e-12 relative (x to its lane's largest entry)."""
    for name in ("iterations", "linearizations", "termination", "success"):
        assert torch.equal(getattr(graphed, name), getattr(eager, name)), name
    for name in ("cost", "initial_cost"):
        a, b = getattr(graphed, name), getattr(eager, name)
        assert float(((a - b).abs() / b.abs().clamp(min=1e-300)).max()) <= 1e-12, name
    assert bool(((graphed.x - eager.x).abs().amax(-1) <= 1e-12 * eager.x.abs().amax(-1)).all())


def _captured_then_replayed(steps, keys):
    """The first call eager, the second capturing each key's three
    segments (initial cost, linearization, trial) and replaying the rest,
    the third replaying every segment the first ran."""
    eager = steps[0]["eager"]
    assert steps[0] == {"captures": 0, "replays": 0, "eager": eager} and eager > 3 * keys
    assert steps[1] == {"captures": 3 * keys, "replays": eager - 3 * keys, "eager": 0}
    assert steps[2] == {"captures": 0, "replays": eager, "eager": 0}


@pytest.mark.parametrize("two_phase", [False, True], ids=["one_phase", "two_phase"])
def test_graphed_bundle_batch_equals_eager(cuda_device, monkeypatch, two_phase):
    """16 lanes of the config-5 set, every other lane's hand-eye seed
    perturbed by 0.26 rad more: those take 5 trials, the rest 4. With a
    first-phase cap of 4 the second phase holds 8 of the 16 lanes, a key
    of its own."""
    p = chip_smoke.bundle_problems(16)
    p["g0"] = p["g0"].copy()
    p["g0"][::2] = p["g0"][::2] @ chip_smoke._pose([0.15, -0.15, 0.15], [0.05, 0.0375, -0.05])
    monkeypatch.setattr(batched, "BUNDLE_PHASE_CAP", 4)
    opts = BundleOptions(core=OptimOptions(max_iterations=50, compute_covariance=False))
    args = chip_smoke.bundle_args(p, cuda_device)
    rephased = profiling.counters().get("dense.rephased_lanes", 0)
    outs, steps = _thrice(lambda: bundle_batch(*args, opts=opts, two_phase=two_phase))
    assert profiling.counters().get("dense.rephased_lanes", 0) - rephased == (24 if two_phase else 0)
    assert bool(outs[0][0].success.all())
    for graphed in outs[1:]:
        _same_trajectory(graphed[0], outs[0][0])
        assert float((graphed[2] - outs[0][2]).abs().max()) <= 1e-12
    _captured_then_replayed(steps, keys=2 if two_phase else 1)


@pytest.mark.parametrize("rot_residual", ["quat", "log"])
def test_graphed_handeye_batch_equals_eager(cuda_device, rot_residual):
    _, bg, ct = chip_smoke.handeye_problems(16)
    ct = ct.copy()
    ct[..., :3, 3] += np.random.default_rng(1).normal(0, 2e-3, ct[..., :3, 3].shape)
    bg, ct = torch.as_tensor(bg, device=cuda_device), torch.as_tensor(ct, device=cuda_device)
    opts = OptimOptions(max_iterations=50)
    outs, steps = _thrice(lambda: handeye_batch(bg, ct, options=opts, rot_residual=rot_residual))
    assert bool(outs[0][0].success.all())
    for graphed in outs[1:]:
        _same_trajectory(graphed[0], outs[0][0])
        assert float((graphed[1] - outs[0][1]).abs().max()) <= 1e-12
    _captured_then_replayed(steps, keys=1)


def test_graphed_lm_cost_trace_equals_eager(cuda_device):
    """``lm_cost_trace`` keeps every step's state: its whole cost curve,
    graphed, is the eager one, and its output is ``lm_core``'s."""
    p = chip_smoke.bundle_problems(16)
    obj, uv, bg, cam_idx, intrs, g0, b0 = chip_smoke.bundle_args(p, cuda_device)
    mask = torch.ones(obj.shape[:-1], dtype=obj.dtype, device=cuda_device)
    gq, gt = blocks.poses_to_quat_tran(g0)
    x0 = torch.cat([intrs.reshape(16, -1), gq.reshape(16, -1), gt.reshape(16, -1),
                    se3.rotmat_to_quat(se3.rot(b0)), se3.tra(b0)], dim=-1)
    pc, c, o, n = 10, 1, obj.shape[1], obj.shape[2]
    free = torch.ones(x0.shape[-1], dtype=torch.bool, device=cuda_device)
    free[:pc] = False

    def res(x, *d):
        return bundle_mod._residual(x, *d, pc, c)

    def jac(x, *d):
        return bundle_mod._residual_jac_pinhole(x, *d, pc, c)

    kw = dict(data=(obj, uv, mask, bg, cam_idx), options=OptimOptions(max_iterations=12), free_mask=free,
              block_ids=np.repeat(np.arange(o), 2 * n), num_blocks=o, jac_fn=jac)
    outs, steps = _thrice(lambda: profiling.lm_cost_trace(res, x0, bundle_mod.make_manifold(pc, c), **kw))
    for out, costs in outs[1:]:
        _same_trajectory(out, outs[0][0])
        assert float(((costs - outs[0][1]).abs() / outs[0][1].abs()).max()) <= 1e-12
    assert bool((outs[0][1][:, :-1] >= outs[0][1][:, 1:]).all())
    _same_trajectory(outs[2][0], lm.lm_core(res, x0, bundle_mod.make_manifold(pc, c), **kw))
    _captured_then_replayed(steps, keys=1)


def _line_problem(dev, b=8):
    manifold = ProductManifold([euclid(2)])
    target = torch.arange(2 * b, dtype=torch.float64, device=dev).reshape(b, 2)

    def jac(x, t):
        return torch.eye(2, dtype=x.dtype, device=x.device).expand(x.shape[0], 2, 2)

    return manifold, target, jac


def test_a_residual_over_a_tensor_runs_eagerly(cuda_device):
    manifold, target, jac = _line_problem(cuda_device)
    scale = torch.full((2,), 0.5, dtype=torch.float64, device=cuda_device)

    def res(x, t):
        return (x - t) * scale

    def jac_scaled(x, t):
        return jac(x, t) * 0.5

    outs, steps = _thrice(lambda: lm.lm_core(res, torch.zeros_like(target), manifold, data=(target,),
                                              jac_fn=jac_scaled))
    assert all(s["captures"] == s["replays"] == 0 and s["eager"] > 0 for s in steps)
    assert bool(outs[2].success.all())


def test_a_segment_that_cannot_be_captured_runs_eagerly_from_then_on(cuda_device):
    """A residual that reads a device value on the host: its capture fails,
    the solve goes on eagerly with the eager result, and the key is never
    captured again; other keys still capture."""
    manifold, target, jac = _line_problem(cuda_device)

    def res(x, t):
        return (x - t) * float(t.abs().max() >= 0)

    outs, steps = _thrice(lambda: lm.lm_core(res, torch.zeros_like(target), manifold, data=(target,),
                                              jac_fn=jac))
    for out in outs[1:]:
        _same_trajectory(out, outs[0])
    assert all(s["captures"] == s["replays"] == 0 and s["eager"] > 0 for s in steps)
    p = chip_smoke.bundle_problems(4)
    args = chip_smoke.bundle_args(p, cuda_device)
    opts = BundleOptions(core=OptimOptions(max_iterations=50, compute_covariance=False))
    before = _graph_counts()
    for _ in range(2):
        bundle_batch(*args, opts=opts, two_phase=False)
    assert _graph_counts()["captures"] - before["captures"] == 3


def test_spd_inverse_captures_in_a_cuda_graph(cuda_device):
    """``spd_inverse`` (two cuBLAS triangular solves, no MAGMA) captured in
    a CUDA graph and replayed on new input: the eager result, and the CPU's
    ``cholesky_solve`` to 1e-12; a lane that is not SPD comes back NaN."""
    rng = np.random.default_rng(5)

    def batch():
        m = torch.as_tensor(rng.normal(size=(64, 10, 6, 6)), device=cuda_device)
        a = m @ m.mT + 6.0 * torch.eye(6, dtype=torch.float64, device=cuda_device)
        a[0, 0] = -a[0, 0]
        return a

    static = batch()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        linalg.spd_inverse(static)  # the libraries' handles, outside the capture
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = linalg.spd_inverse(static)
    fresh = batch()
    static.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.isnan(out[0, 0]).all() and torch.isfinite(out[1:]).all() and torch.isfinite(out[0, 1:]).all()
    eager = linalg.spd_inverse(fresh)
    assert torch.equal(torch.nan_to_num(out, nan=7.0), torch.nan_to_num(eager, nan=7.0))
    a = fresh.cpu()
    want = torch.cholesky_solve(torch.eye(6, dtype=a.dtype).expand(a.shape), linalg.cholesky(a))
    assert float((out.cpu()[1:] - want[1:]).abs().max()) <= 1e-12 * float(want[1:].abs().max())


def test_graphed_intrinsics_facade_equals_eager(cuda_device):
    """The benchmark's path at 64 sensors: the phased Schur solve, its
    second phase padded (``batched._padded_lanes``), then the covariance. Graphed, the
    eager trajectory (equal counters; cost, x and covariance to 1e-12),
    both phases' keys captured on the second call and replayed from
    then on; the padding is not counted as rephased."""
    obj, uv, _ = chip_smoke.make_problems(64)
    obj, uv = torch.as_tensor(obj, device=cuda_device), torch.as_tensor(uv, device=cuda_device)
    rephased = profiling.counters().get("schur.rephased_lanes", 0)
    outs, steps = _thrice(lambda: intrinsics_facade_batch(obj, uv, opts=chip_smoke.FACADE_OPTS, two_phase=True),
                          prefix="schur")
    moved = profiling.counters().get("schur.rephased_lanes", 0) - rephased
    eager = outs[0][2]
    assert moved > 0 and moved == 3 * int((eager[0].iterations > batched.TWO_PHASE_CAP_A).sum())
    assert bool(eager[0].success.all())
    for graphed in outs[1:]:
        _same_trajectory(graphed[2][0], eager[0])
        scale = eager[4].abs().amax(dim=(-2, -1))
        assert bool(((graphed[2][4] - eager[4]).abs().amax(dim=(-2, -1)) <= 1e-12 * scale).all())
        assert torch.equal(graphed[2][5], eager[5])
    _captured_then_replayed(steps, keys=2)


def test_graphed_mixed_jac_intrinsics_equal_eager(cuda_device):
    """"mixed_jac": a float32-Jacobian Schur solve, then the float64
    polish, two keys, each graphed."""
    obj, uv, _ = chip_smoke.make_problems(16)
    obj, uv = torch.as_tensor(obj, device=cuda_device), torch.as_tensor(uv, device=cuda_device)
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=40, compute_covariance=False))
    outs, steps = _thrice(lambda: intrinsics_batch(obj, uv, opts=opts, precision="mixed_jac", two_phase=False)[1],
                          prefix="schur")
    assert bool(outs[0][0].success.all())
    for graphed in outs[1:]:
        _same_trajectory(graphed[0], outs[0][0])
    _captured_then_replayed(steps, keys=2)


def test_graphed_stereo_extrinsics_equal_eager(cuda_device):
    """The stereo rig's Schur solve (analytic pinhole Jacobian, camera
    quaternions in the global block, two loss blocks a view), one phase
    with covariance: graphed, the eager trajectory and covariance."""
    p = chip_smoke.stereo_problems(8)
    opts = ExtrinsicOptions(core=OptimOptions(max_iterations=50, compute_covariance=True))
    args = [torch.as_tensor(p[k], device=cuda_device) for k in ("obj", "uv", "intr0", "c0", "r0")]
    outs, steps = _thrice(lambda: extrinsics_batch(*args, opts=opts), prefix="schur")
    assert bool(outs[0][0].success.all()) and bool(outs[0][5].all())
    for graphed in outs[1:]:
        _same_trajectory(graphed[0], outs[0][0])
        scale = outs[0][4].abs().amax(dim=(-2, -1))
        assert bool(((graphed[4] - outs[0][4]).abs().amax(dim=(-2, -1)) <= 1e-12 * scale).all())
    _captured_then_replayed(steps, keys=1)


def test_forward_mode_schur_solve_runs_eagerly(cuda_device):
    """Scheimpflug's forward-mode Jacobian keeps host state: every segment
    of every call runs eagerly (``schur.graph.eager`` alone), with the
    same result each time."""
    o, u, _ = chip_smoke.scheimpflug_problems(4, (0.05, -0.03))
    o, u = torch.as_tensor(o, device=cuda_device), torch.as_tensor(u, device=cuda_device)
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=30), fixed_distortion_indices=(2, 3))
    outs, steps = _thrice(lambda: intrinsics_batch(o, u, opts=opts, model_name=chip_smoke.SCHEIM_NAME,
                                                   two_phase=False)[1], prefix="schur")
    assert all(s["captures"] == s["replays"] == 0 and s["eager"] > 0 for s in steps)
    for out in outs[1:]:
        _same_trajectory(out[0], outs[0][0])


def test_a_failed_schur_capture_falls_back_to_eager(cuda_device, monkeypatch):
    """A capture that fails (planted): the key runs eagerly from then on,
    with the eager result."""
    def fail(*args, **kwargs):
        raise RuntimeError("planted capture failure")

    monkeypatch.setattr(lm_graphs._Entry, "capture", fail)
    obj, uv, _ = chip_smoke.make_problems(16)
    obj, uv = torch.as_tensor(obj, device=cuda_device), torch.as_tensor(uv, device=cuda_device)
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=40, compute_covariance=False))
    outs, steps = _thrice(lambda: intrinsics_batch(obj, uv, opts=opts, two_phase=False)[1], prefix="schur")
    assert all(s["captures"] == s["replays"] == 0 and s["eager"] > 0 for s in steps)
    assert steps[1]["eager"] == steps[2]["eager"] == steps[0]["eager"]
    for out in outs[1:]:
        _same_trajectory(out[0], outs[0][0])
