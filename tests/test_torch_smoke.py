"""CPU rehearsal of ``chip_smoke.py``'s app, stereo, pipeline, homography,
hand-eye, bundle, four-stage pipeline, line-scan (5L, 5R, 5S), Scheimpflug
intrinsics (2S, 2T), line-scan app, planar-pose, semi-DLT and Scheimpflug
stereo and bundle, mesh, mixed-precision and cost-trace phases, which
otherwise run only on the card: the same generators at a small size (4 sensors, 4 rigs, 4 or 64
lanes), the apps and the solves on the CPU, and the phases' own checks, so
a wrong path, shape or threshold shows here before a chip run.
Also: the script refuses to run without a card, and outside the
repository. No JAX is imported."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from calibration_tpu_torch.ops import ransac
from calibration_tpu_torch.parallel import extrinsics_batch
from calibration_tpu_torch.pipeline import loaders, stages
from torch_helpers import ransac_rounds

ROOT = Path(__file__).resolve().parent.parent


def test_app_phase_checks_pass_on_cpu(tmp_path):
    """The 2 px threshold keeps every clean point of the generator's views
    (distortion included) and rejects every displaced one; all cameras
    converge at the injected noise; every layer is timed."""
    config, features, displaced = chip_smoke.write_fleet(tmp_path, 4)
    before = ransac_rounds("cpu")
    reader = loaders.read_detections
    report, wall, seconds = chip_smoke.run_app(config, features, tmp_path / "r.json", "cpu")
    assert loaders.read_detections is reader  # the timers are taken off again
    assert ransac_rounds("cpu") > before
    chip_smoke.check_fleet_report(report, displaced)
    assert set(seconds) == {"ingest", "prefilter", "solve", "qa_kernel", "report"}
    assert 0 < sum(seconds.values()) <= wall
    chip_smoke.check_parity(report, report, "self")


def test_fleet_generator_does_not_depend_on_fleet_size(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    _, small, d_small = chip_smoke.write_fleet(tmp_path / "a", 2)
    _, large, d_large = chip_smoke.write_fleet(tmp_path / "b", 3)
    assert (d_large[:2] == d_small).all()
    assert [Path(p).read_text() for p in large[:2]] == [Path(p).read_text() for p in small]


def test_stereo_phase_checks_pass_on_cpu():
    """4 rigs of the config-3 set on the phased schedule the card runs at
    B = 128: every rig converges, camera 1 within the pose bound."""
    p = chip_smoke.stereo_problems(4)
    out = extrinsics_batch(
        *(torch.as_tensor(p[k]) for k in ("obj", "uv", "intr0", "c0", "r0")),
        opts=chip_smoke.STEREO_OPTS, two_phase=True,
    )
    chip_smoke.check_stereo(out, p["rel_gt"])
    assert int(out[0].iterations.max()) > 5  # past the first phase


def test_stereo_problems_restate_the_benchmark_set():
    """The generator equals the JAX package's benchmarks/problems.py one.
    Asked of a fresh interpreter: that module sets torch's default dtype."""
    code = (
        "import numpy as np, chip_smoke\n"
        "from benchmarks import problems\n"
        "want, got = problems.stereo_problems(3), chip_smoke.stereo_problems(3)\n"
        "assert sorted(want) == sorted(got)\n"
        "for k in want:\n"
        "    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_pipeline_phase_checks_pass_on_cpu(tmp_path):
    """The pipeline app on 4 rigs: every pair ok, every rig converged,
    camera 1 within the pose bound, every layer timed; the timers come off
    again."""
    input_path = chip_smoke.write_rigs(tmp_path, 4)
    run = stages.IntrinsicStage.run
    art, wall, seconds = chip_smoke.run_pipeline(input_path, tmp_path / "a.json", "cpu")
    assert stages.IntrinsicStage.run is run
    chip_smoke.check_pipeline_artifacts(art, 4)
    assert set(seconds) == {"ingest", "intrinsics", "stereo", "multicam", "writing"}
    assert 0 < sum(seconds.values()) <= wall
    files = sorted(p.name for p in tmp_path.glob("detections_*.json"))
    assert len(files) == 8 and files[0] == "detections_rig000_cam0.json"


def test_rig_generator_does_not_depend_on_fleet_size(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    chip_smoke.write_rigs(tmp_path / "a", 2)
    chip_smoke.write_rigs(tmp_path / "b", 3)
    for name in ("detections_rig000_cam0.json", "detections_rig001_cam1.json"):
        assert (tmp_path / "a" / name).read_text() == (tmp_path / "b" / name).read_text()


def test_kernel_phase_checks_pass_on_cpu(monkeypatch):
    """K1's phase at small shapes, with the CPU's plain versions in the
    wrappers' place: every check of both modes holds, the worst errors are
    reported per mode."""
    monkeypatch.setattr(chip_smoke, "QA_SHAPES", ((4, 3, 37), (2, 2, 20), (3, 1, 50)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    worst = chip_smoke.kernel_phase(torch.device("cpu"))
    assert set(worst) == {"residuals", "rms"}
    assert 0 < worst["residuals"] <= chip_smoke.KERNEL_ATOL_PX and 0 < worst["rms"] <= chip_smoke.KERNEL_ATOL_PX


def test_old_qa_pass_is_the_rms_of_the_residual_mode():
    """The smoke's old unfused pass computes the RMS mode's function: on the
    CPU both are the plain RMS, bit for bit."""
    args = chip_smoke.qa_inputs(4, 3, 37, 1, torch.float64, torch.float64, "cpu")
    got = chip_smoke.old_qa_pass(*args)
    assert torch.equal(got, chip_smoke.pr.projection_rms_f32(*args))
    assert float(got.reshape(-1)[3]) == 0.0  # qa_inputs masks view 3 whole


@pytest.mark.parametrize("mode,size,want_us", [("rms", 8, 2.772), ("residuals", 4, 1.950)])
def test_k1_bound_at_the_facade_shape(mode, size, want_us):
    """2560 x 88: RMS mode from float64 moves 9.29 MB, residual mode from
    float32 6.53 MB; both are bound by HBM bytes."""
    ms, by = chip_smoke.bound_ms(mode, 256, 10, 88, size, size)
    assert by == "bytes" and abs(ms * 1e3 - want_us) < 1e-3


def test_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_smoke_refuses_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_homography_phase_checks_pass_on_cpu(monkeypatch):
    """Config 1 at 64 lanes (phased, as on the card): every check holds
    and the warm time comes back."""
    monkeypatch.setattr(chip_smoke, "HOMOG_LANES", 64)
    monkeypatch.setattr(chip_smoke, "HOMOG_PARITY_LANES", 4)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    assert chip_smoke.homography_phase(torch.device("cpu"), "cpu") > 0


def test_handeye_phase_checks_pass_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "HANDEYE_RIGS", 4)
    monkeypatch.setattr(chip_smoke, "HANDEYE_PARITY_RIGS", 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    assert chip_smoke.handeye_phase(torch.device("cpu"), "cpu") > 0


def test_handeye_pipeline_phase_checks_pass_on_cpu(tmp_path):
    """The four-stage pipeline on 4 rigs: every hand-eye and bundle rig ok
    within its pose bound, the bundle seeded by the hand-eye stage (the
    fused path), no QA warning, every layer timed; the timers come off
    again."""
    fleet = chip_smoke.write_handeye_fleet(tmp_path, 4)
    run = stages.BundleAdjustmentStage.run
    art, wall, seconds = chip_smoke.run_handeye_pipeline(fleet["input_path"], tmp_path / "a.json", "cpu")
    assert stages.BundleAdjustmentStage.run is run
    chip_smoke.check_handeye_artifacts(art, fleet)
    assert set(seconds) == {"ingest", "intrinsics", "hand_eye", "bundle", "writing"}
    assert 0 < sum(seconds.values()) <= wall


@pytest.mark.parametrize("variant,stage_names", [
    ("handeye", ["intrinsics", "hand_eye"]), ("staged", ["intrinsics", "bundle"]),
])
def test_pipeline_variants_pass_their_checks_on_cpu(tmp_path, variant, stage_names):
    """The smoke's parity inputs: without the bundle section, and with the
    hand-eye observations moved into the bundle rigs (DLT seeds, the staged
    path)."""
    fleet = chip_smoke.write_handeye_fleet(tmp_path, 4)
    path = chip_smoke.pipeline_variant(fleet["input_path"], variant)
    art, _, _ = chip_smoke.run_handeye_pipeline(path, tmp_path / "a.json", "cpu")
    assert [s["name"] for s in art["pipeline_summary"]["stages"]] == stage_names
    chip_smoke.check_handeye_artifacts(art, fleet, "dlt")


def test_bundle_phase_checks_pass_on_cpu(monkeypatch):
    """Config 5 at 4 lanes: every check holds (the parity on 2 lanes
    against themselves, on the card's schedule) and the warm median comes
    back."""
    monkeypatch.setattr(chip_smoke, "BUNDLE_RIGS", 4)
    monkeypatch.setattr(chip_smoke, "BUNDLE_PARITY_RIGS", 2)
    monkeypatch.setattr(chip_smoke, "WARM_CALLS", 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    assert chip_smoke.bundle_phase(torch.device("cpu"), "cpu") > 0


def _small_cells(monkeypatch):
    for name, value in (("LINESCAN_RIGS", 4), ("LINESCAN_PARITY_RIGS", 2), ("LINESCAN_RANSAC_RIGS", 4),
                        ("LINESCAN_RANSAC_PARITY_RIGS", 2), ("SCHEIM_RIGS", 4), ("SCHEIM_PARITY_RIGS", 2),
                        ("WARM_CALLS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_linescan_phase_checks_pass_on_cpu(monkeypatch):
    """Row 5L at 4 rigs: every rig ok within the angle bound, no K1
    launch, the parity on 2 rigs against themselves, the warm median back."""
    _small_cells(monkeypatch)
    assert chip_smoke.linescan_phase(torch.device("cpu"), "cpu") > 0


@pytest.mark.parametrize("row", ["5R", "5S"])
def test_linescan_ransac_phase_checks_pass_on_cpu(monkeypatch, row):
    """Rows 5R and 5S at 4 rigs, the junk pixels in: every rig ok within
    the angle bound, RANSAC rounds counted on the phase's device."""
    _small_cells(monkeypatch)
    assert chip_smoke.linescan_ransac_phase(torch.device("cpu"), "cpu", row) > 0


@pytest.mark.parametrize("row", ["2S", "2T"])
def test_scheimpflug_phase_checks_pass_on_cpu(monkeypatch, row):
    """Rows 2S and 2T at 4 lanes: every lane converged, the tilt gates,
    the RMS at the noise, covariance finite (2S), no K1 launch."""
    _small_cells(monkeypatch)
    assert chip_smoke.scheimpflug_phase(torch.device("cpu"), "cpu", row) > 0


def test_linescan_app_phase_checks_pass_on_cpu():
    """The app on the example, its RANSAC variant and the Scheimpflug input:
    exit 0, no K1 launch, the artifact within the report bounds."""
    chip_smoke.linescan_app_phase("cpu", device="cpu")


def test_ransac_draws_do_not_depend_on_the_device():
    """round_noise draws on the CPU and moves the noise: every device gets
    the same stream, so card/CPU RANSAC lanes can be held equal."""
    a = ransac.round_noise(5, 2, (8, 16), torch.device("cpu"))
    b = ransac.round_noise(5, 2, (8, 16), "cpu")
    assert torch.equal(a, b) and a.device.type == "cpu"


SOLVER_PHASES = {
    "planar_pose": ("planar_pose_phase", (("PLANAR_CAMERAS", 2), ("PLANAR_PARITY_LANES", 4))),
    "semidlt": ("semidlt_phase", (("SEMIDLT_CAMERAS", 2), ("SEMIDLT_PARITY_CAMERAS", 1))),
    "stereo_scheimpflug": ("stereo_scheimpflug_phase", (("STEREO_RIGS", 2), ("SOLVER_PARITY_RIGS", 1))),
    "bundle_scheimpflug": ("bundle_scheimpflug_phase", (("BUNDLE_RIGS", 2), ("SOLVER_PARITY_RIGS", 1))),
}


@pytest.mark.parametrize("phase", sorted(SOLVER_PHASES))
def test_solver_phases_check_pass_on_cpu(monkeypatch, phase):
    """The planar-pose (20 views), semi-DLT (2 cameras) and Scheimpflug
    stereo and bundle (2 rigs) cells: every lane converged within the
    truth bounds, no K1 launch, the parity on the first lanes against
    themselves, the warm median back."""
    name, sizes = SOLVER_PHASES[phase]
    for attr, value in sizes + (("WARM_CALLS", 2),):
        monkeypatch.setattr(chip_smoke, attr, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    assert getattr(chip_smoke, name)(torch.device("cpu"), "cpu") > 0


@pytest.mark.parametrize("which", ["homography", "handeye", "bundle", "handeye_fleet", "linescan",
                                   "linescan_scheimpflug", "linescan_outliers", "scheimpflug", "planar_semidlt",
                                   "stereo_scheimpflug", "bundle_scheimpflug"])
def test_generators_restate_the_benchmark_sets(which):
    """chip_smoke's config-1, config-4 and config-5 sets, its pipeline
    fleet and its line-scan sets equal the JAX package's
    benchmarks/problems.py and benchmarks/pipeline_fleet.py ones (the fleet
    with its bundle section); its junk-pixel recipe and its Scheimpflug
    intrinsics sets equal bench_all.py's (rows 5R / 5S, 2S / 2T). The
    planar-pose and semi-DLT cells are bench.py's set (k3 = 0; every view a
    planar-pose lane, K at the truth) and the Scheimpflug stereo and bundle
    cells the config-3 and config-5 sets rendered through the JAX package's
    numpy Scheimpflug projection (tau = (0.06, -0.04), p1 = p2 = 0). Asked
    of a fresh interpreter: those modules set torch's default dtype."""
    scheimpflug_render = (
        "intr12 = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.12, 0.04, 0.0, 0.0, 0.0, 0.06, -0.04])\n"
        "problems.np_project = lambda intr, pc: problems.np_project_scheimpflug(intr12, pc)\n"
    )
    code = {
        "planar_semidlt": (
            "import bench\n"
            "obj, uv, poses, intr = bench.make_problems(3, seed=7)\n"
            "assert np.asarray(intr)[7] == 0.0\n"
            "want = [obj.reshape(30, 88, 2), uv.reshape(30, 88, 2), np.tile(np.asarray(intr)[:5], (30, 1)),\n"
            "        poses.reshape(30, 4, 4)]\n"
            "got = list(chip_smoke.planar_problems(3))\n"
            "want, got = want + [obj, uv, intr], got + list(chip_smoke.make_problems(3))\n"
        ),
        "stereo_scheimpflug": scheimpflug_render + (
            "keys = ['obj', 'uv', 'c0', 'r0', 'rel_gt']\n"
            "w, g = problems.stereo_problems(3), chip_smoke.stereo_problems(3, tilt_tau=(0.06, -0.04))\n"
            "want, got = [w[k] for k in keys] + [intr12], [g[k] for k in keys] + [g['intr0'][0, 1]]\n"
        ),
        "bundle_scheimpflug": scheimpflug_render + (
            "w = problems.bundle_problems(3, num_obs=6)\n"
            "g = chip_smoke.bundle_problems(3, num_obs=6, tilt_tau=(0.06, -0.04))\n"
            "keys = [k for k in sorted(w) if k != 'intr']\n"
            "want, got = [w[k] for k in keys] + [intr12], [g[k] for k in keys] + [g['intr']]\n"
        ),
        "linescan": "want, got = problems.linescan_problems(3, seed=23), chip_smoke.linescan_problems(3, seed=23)\n",
        "linescan_scheimpflug": (
            "want = problems.linescan_problems(3, views=4, seed=37, tilt_tau=(0.06, -0.04))\n"
            "got = chip_smoke.linescan_problems(3, views=4, seed=37, tilt_tau=(0.06, -0.04))\n"
        ),
        "linescan_outliers": (
            "luv = problems.linescan_problems(3, seed=31)[3]\n"
            "rng = np.random.default_rng(32)\n"
            "out = rng.random(luv.shape[:-1]) < 0.2\n"
            "junk = rng.uniform(0, 640, luv.shape)\n"
            "want, got = [np.where(out[..., None], junk, luv)], [chip_smoke.with_laser_outliers(luv, 31)]\n"
        ),
        "scheimpflug": (
            "import bench, jax.numpy as jnp\n"
            "from calibration_tpu.models import scheimpflug\n"
            "from calibration_tpu.ops import se3\n"
            "want, got = [], []\n"
            "for tilt in ((0.05, -0.04), (0.09, -0.07)):\n"
            "    obj, _, poses, intr10 = bench.make_problems(3, seed=7)\n"
            "    intr10 = np.asarray(intr10).copy()\n"
            "    intr10[8:10] = 0.0\n"
            "    intr12 = np.concatenate([intr10, tilt])\n"
            "    obj3 = jnp.concatenate([jnp.asarray(obj), jnp.zeros(obj.shape[:-1] + (1,))], -1)\n"
            "    uv = np.asarray(scheimpflug.project(jnp.asarray(intr12), se3.se3_apply(jnp.asarray(poses)[:, :, None], obj3)))\n"
            "    want += [obj, uv + np.random.default_rng(8).normal(0, 0.2, uv.shape), intr12]\n"
            "    got += list(chip_smoke.scheimpflug_problems(3, tilt))\n"
        ),
        "homography": "want, got = problems.homography_problems(5), chip_smoke.homography_problems(5)\n",
        "handeye": "want, got = problems.handeye_problems(3, 7), chip_smoke.handeye_problems(3, 7)\n",
        "bundle": (
            "w, g = problems.bundle_problems(3, num_obs=6), chip_smoke.bundle_problems(3, num_obs=6)\n"
            "assert sorted(w) == sorted(g)\n"
            "want, got = [w[k] for k in sorted(w)], [g[k] for k in sorted(w)]\n"
        ),
        "handeye_fleet": (
            "import json, tempfile, pathlib\n"
            "from benchmarks import pipeline_fleet\n"
            "a, b = tempfile.mkdtemp(), tempfile.mkdtemp()\n"
            "w, g = pipeline_fleet.make_fleet(a, rigs=3), chip_smoke.write_handeye_fleet(b, 3)\n"
            "keys = ['obj', 'uv', 'bg', 'ct_gt', 'intr', 'g_gt', 'bt_gt']\n"
            "want, got = [w[k] for k in keys], [g[k] for k in keys]\n"
            "jw, jg = json.loads(pathlib.Path(w['input_path']).read_text()), json.loads(pathlib.Path(g['input_path']).read_text())\n"
            "assert jw['bundle'] == jg['bundle'] and sorted(jw) == sorted(jg)\n"
            "assert jw['planar_detections'] == jg['planar_detections']\n"
            "bases = [[o.pop('base_se3_gripper') for r in j['hand_eye']['rigs'] for o in r['observations']] for j in (jw, jg)]\n"
            "np.testing.assert_allclose(bases[1], bases[0], rtol=0, atol=1e-12)\n"
            "assert jw['hand_eye'] == jg['hand_eye']\n"
            "for name in ('planar_intrinsics_config.json', 'detections_cam1.json'):\n"
            "    dw, dg = (json.loads((pathlib.Path(d) / name).read_text()) for d in (a, b))\n"
            "    if 'images' in dw:\n"
            "        pw, pg = dw.pop('images'), dg.pop('images')\n"
            "        assert [i['file'] for i in pw] == [i['file'] for i in pg]\n"
            "        np.testing.assert_allclose([[p['x'], p['y']] for i in pg for p in i['points']],\n"
            "                                   [[p['x'], p['y']] for i in pw for p in i['points']], atol=1e-9)\n"
            "        dw['metadata'] = dg['metadata'] = dw['params_hash'] = dg['params_hash'] = None\n"
            "    assert dw == dg, name\n"
        ),
    }[which]
    code = (
        "import numpy as np, chip_smoke\nfrom benchmarks import problems\n" + code
        + "for w, g in zip(want, got):\n    np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


NEW_PHASES = {
    # the mesh phase on CPU meshes: one device for "every card", then 4
    # shards; config 2 at 6 cameras and planar pose at 9 views pad to 8 and 12
    "mesh": ("mesh_phase", (("FLEET", 4), ("MESH_FACADE_CAMERAS", 6), ("MESH_BUNDLE_RIGS", 6),
                            ("PLANAR_CAMERAS", 1), ("MESH_PLANAR_VIEWS", 9), ("MESH_WARM_CALLS", 2))),
    "mixed": ("mixed_phase", (("MIXED_CAMERAS", 4), ("BUNDLE_RIGS", 4))),
    "trace": ("trace_phase", (("HOMOG_LANES", 16), ("FLEET", 4))),
}


@pytest.mark.parametrize("phase", sorted(NEW_PHASES))
def test_mesh_mixed_and_trace_phases_check_pass_on_cpu(monkeypatch, phase):
    """The three phases at small size: every lane converged within the
    truth bounds, sharded results equal to the unsharded single-phase
    call, the mixed precisions' costs within 1e-7 of f64, the cost trace
    equal to lm_core's and never rising, the device trace written (the K1
    launch checks are the card's)."""
    name, sizes = NEW_PHASES[phase]
    for attr, value in sizes + (("WARM_CALLS", 2),):
        monkeypatch.setattr(chip_smoke, attr, value)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    getattr(chip_smoke, name)(torch.device("cpu"), "cpu")

