"""Port equivalence of the bundle-adjustment slice, CPU, float64, each piece
against its JAX counterpart on the same numpy inputs: the analytic bundle
Jacobian (against the port's jacfwd and JAX's analytic one),
``optimize_bundle_device`` under each ``BundleOptions`` flag with
covariance on and off, ``bundle_batch`` (one phase against JAX; phased
against one phase; the budget; covariance forcing one phase), the bundle
fleet functions with one bucket and with two, ``BundleAdjustmentStage`` on
its fused and staged paths with every status, and the four-stage
``bundle_pipeline`` app.

Data: rigs of one or two cameras, each observation one camera's view of a
6x8 grid at a robot pose drawn so the target faces the camera, 0.2 px
noise, the truth perturbed by fixed small poses as seeds.

Bars: Jacobians 1e-10 relative to max(1, |entry|); solves with iterations,
linearizations and termination exactly equal per rig, cost 1e-10
relative, poses 1e-9 absolute, covariance 1e-8 of its largest entry; stage
and app artifacts within ``torch_helpers.report_tolerance``.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from calibration_tpu.apps import bundle_pipeline as japp
from calibration_tpu.io import jsonio as jjsonio
from calibration_tpu.optim import BundleOptions as JBundleOptions
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.optim import bundle as jbundle
from calibration_tpu.optim.core import OptimResult as JOptimResult
from calibration_tpu.optim.handeye import HandeyeResult as JHandeyeResult
from calibration_tpu.optim.intrinsics import IntrinsicsOptimizationResult as JIntrResult
from calibration_tpu.parallel import batched as jbatched
from calibration_tpu.pipeline import BundleAdjustmentStage as JStage
from calibration_tpu.pipeline import PipelineContext as JContext
from calibration_tpu.pipeline import fleet as jfleet
from calibration_tpu.pipeline.dataset import CalibrationDataset as JDataset
from calibration_tpu.pipeline.dataset import PlanarDetections as JDetections
from calibration_tpu.pipeline.facades import handeye as jfh
from calibration_tpu.pipeline.facades.intrinsics import IntrinsicCalibrationOutputs as JIntrOut
from calibration_tpu_torch import convert
from calibration_tpu_torch.apps import bundle_pipeline as tapp
from calibration_tpu_torch.io import jsonio as tjsonio
from calibration_tpu_torch.ops import se3
from calibration_tpu_torch.optim import bundle as tbundle
from calibration_tpu_torch.optim import lm as tlm
from calibration_tpu_torch.optim.core import OptimResult as TOptimResult
from calibration_tpu_torch.optim.handeye import HandeyeResult as THandeyeResult
from calibration_tpu_torch.optim.intrinsics import IntrinsicsOptimizationResult as TIntrResult
from calibration_tpu_torch.parallel import batched as tbatched
from calibration_tpu_torch.pipeline import BundleAdjustmentStage as TStage
from calibration_tpu_torch.pipeline import PipelineContext as TContext
from calibration_tpu_torch.pipeline import fleet as tfleet
from calibration_tpu_torch.pipeline.dataset import CalibrationDataset as TDataset
from calibration_tpu_torch.pipeline.dataset import PlanarDetections as TDetections
from calibration_tpu_torch.pipeline.facades import handeye as tfh
from calibration_tpu_torch.pipeline.facades.intrinsics import IntrinsicCalibrationOutputs as TIntrOut
from torch_helpers import assert_reports_match, one_torch_thread, t64  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
INPUT = ROOT / "examples" / "data" / "bundle_input.json"
GRID = chip_smoke._grid(6, 8, 0.03)
INTR = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.12, 0.04, 0.0, 1e-4, -5e-5])
BT = chip_smoke._pose([0.05, 0.03, -0.08], [0.4, -0.1, 0.2])
DG = chip_smoke._pose([0.008, -0.006, 0.01], [0.003, -0.002, 0.004])
DB = chip_smoke._pose([-0.005, 0.007, -0.004], [0.002, 0.003, -0.002])
PC = 10


def _cameras(c):
    cams = np.tile(INTR, (c, 1))
    cams[1:, :4] += [5.0, -4.0, 3.0, -2.0]
    return cams


def _hand_eye(rng, c):
    return np.stack([chip_smoke._pose(rng.uniform(-0.2, 0.2, 3), rng.uniform(-0.05, 0.05, 3)) for _ in range(c)])


def _camera_view(rng):
    return chip_smoke._pose(rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.08, 0.08, 3) + [0.0, 0.0, 0.7])


def scene(seed, c=2, o=8, noise=0.2):
    """One rig: c cameras, o observations (camera o mod c), noisy pixels of
    GRID. Returns a dict of numpy arrays with the truth and the seeds."""
    rng = np.random.default_rng(seed)
    cams, g = _cameras(c), _hand_eye(rng, c)
    cam_idx = np.arange(o) % c
    bg, uv = [], []
    for k in range(o):
        ct = _camera_view(rng)
        bg.append(BT @ np.linalg.inv(ct) @ np.linalg.inv(g[cam_idx[k]]))
        uv.append(chip_smoke._render(cams[cam_idx[k]], ct[None], GRID, noise, rng)[0])
    return dict(obj=np.tile(GRID[None], (o, 1, 1)), uv=np.stack(uv), bg=np.stack(bg), cam_idx=cam_idx, cams=cams,
                g=g, g0=g @ DG, b0=BT @ DB, mask=np.ones((o, GRID.shape[0])))


def batch(seeds, **kw):
    scenes = [scene(s, **kw) for s in seeds]
    return {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}


ARGS = ("obj", "uv", "bg", "cam_idx", "cams", "g0", "b0")


def _port_args(p):
    return [torch.tensor(p[k]) for k in ARGS]


def _jax_solve(p, opts, **kw):
    def one(o, u, bg, ci, k, g, b, m):
        return jbundle.optimize_bundle_device(o, u, bg, ci, k, g, b, mask=m, opts=opts, **kw)

    return jax.device_get(jax.jit(jax.vmap(one))(*(jnp.asarray(p[k]) for k in ARGS + ("mask",))))


def _assert_solves_equal(got, want, pose_atol=1e-9):
    for name in ("iterations", "linearizations", "termination", "success"):
        np.testing.assert_array_equal(getattr(got[0], name).numpy(), np.asarray(getattr(want[0], name)), err_msg=name)
    np.testing.assert_allclose(got[0].cost.numpy(), want[0].cost, rtol=1e-10)
    for i in (1, 2, 3):
        np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0, atol=pose_atol * max(1.0, np.abs(want[i]).max()))
    np.testing.assert_array_equal(got[5].numpy(), want[5])
    scale = np.maximum(np.abs(want[4]).max(axis=(-2, -1)), 1e-300)
    assert np.all(np.abs(got[4].numpy() - want[4]).max(axis=(-2, -1)) <= 1e-8 * scale)


# ------------------------------------------------------------ the Jacobian


def test_analytic_jacobian_matches_jacfwd_and_jax():
    """C = 2, cameras picked per observation, masked points, an iterate
    off the solution: the analytic Jacobian against the port's jacfwd of
    the retracted residual and against JAX's analytic one, per lane."""
    p = batch((3, 4), c=2, o=6)
    rng = np.random.default_rng(2)
    p["mask"] = (rng.uniform(size=p["mask"].shape) > 0.2).astype(float)
    p["cam_idx"][1] = [1, 0, 0, 1, 1, 0]
    gq, gt = (torch.tensor(a) for a in _quat_tran(p["g0"]))
    bq, bt = (torch.tensor(a) for a in _quat_tran(p["b0"]))
    x = torch.cat([torch.tensor(p["cams"]).reshape(2, -1), gq.reshape(2, -1), gt.reshape(2, -1), bq, bt], dim=-1)
    data = (t64(p["obj"]), t64(p["uv"]), t64(p["mask"]), t64(p["bg"]), torch.tensor(p["cam_idx"]))
    got = tbundle._residual_jac_pinhole(x, *data, PC, 2).numpy()
    manifold = tbundle.make_manifold(PC, 2)
    r_fwd, j_fwd = tlm.tangent_jacobian(lambda xx, *d: tbundle._residual(xx, *d, PC, 2), manifold, x, data)
    np.testing.assert_array_equal(r_fwd.numpy(), tbundle._residual(x, *data, PC, 2).numpy())
    scale = np.maximum(1.0, np.abs(j_fwd.numpy()))
    np.testing.assert_allclose(got / scale, j_fwd.numpy() / scale, atol=1e-10)
    for i in range(2):
        want = np.asarray(jbundle._residual_jac_pinhole(
            jnp.asarray(x[i].numpy()), *(jnp.asarray(d[i].numpy()) for d in data), PC, 2
        ))
        scale = np.maximum(1.0, np.abs(want))
        np.testing.assert_allclose(got[i] / scale, want / scale, atol=1e-10)


def _quat_tran(poses):
    """(quaternion, translation) of poses, through the port's se3."""
    t = torch.tensor(poses)
    return se3.rotmat_to_quat(t[..., :3, :3]).numpy(), t[..., :3, 3].numpy()


# ----------------------------------------------------------- the solves

FLAG_CASES = {
    "default": {},
    "intrinsics": {"optimize_intrinsics": True},
    "intrinsics_skew": {"optimize_intrinsics": True, "optimize_skew": True},
    "no_target": {"optimize_target_pose": False},
    "no_hand_eye": {"optimize_hand_eye": False},
}


@pytest.mark.parametrize("covariance", [True, False], ids=["cov", "no_cov"])
@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_optimize_bundle_device_matches_jax(case, covariance):
    """Three two-camera rigs under each flag (intrinsics seeded off the
    truth when free): JAX's jacfwd solve vmapped against the port's
    analytic one."""
    p = batch((5, 6, 7))
    if "optimize_intrinsics" in FLAG_CASES[case]:
        p["cams"] = p["cams"] + np.array([4.0, -3.0, 2.0, -2.0] + [0.0] * 6)
    core = JOptimOptions(max_iterations=50, compute_covariance=covariance)
    jopts = JBundleOptions(core=core, **FLAG_CASES[case])
    want = _jax_solve(p, jopts)
    got = tbundle.optimize_bundle_device(*_port_args(p), mask=t64(p["mask"]), opts=convert.bundle_options(jopts))
    _assert_solves_equal(got, want)
    assert bool(got[0].success.all()) and bool(got[5].all()) == covariance
    if not covariance:
        n = 2 * PC + 7 * 2 + 7
        assert got[4].shape == (3, n, n) and not bool(got[4].any())


def test_jacfwd_path_matches_jax():
    """analytic_jac=False runs torch.func.vmap(jacfwd) of the residual."""
    p = batch((5, 6))
    jopts = JBundleOptions(core=JOptimOptions(max_iterations=50), optimize_intrinsics=True)
    want = _jax_solve(p, jopts)
    got = tbundle.optimize_bundle_device(*_port_args(p), opts=convert.bundle_options(jopts), analytic_jac=False)
    _assert_solves_equal(got, want)


def test_host_wrapper_matches_jax():
    p = scene(8, c=1)
    jopts = JBundleOptions(core=JOptimOptions(max_iterations=50))
    want = jbundle.optimize_bundle(*(p[k] for k in ARGS), opts=jopts)
    got = tbundle.optimize_bundle(*(torch.tensor(p[k]) for k in ARGS), opts=convert.bundle_options(jopts))
    assert got.core.report == want.core.report and got.core.success
    np.testing.assert_allclose(got.core.final_cost, want.core.final_cost, rtol=1e-10)
    for name in ("cameras", "g_se3_c", "b_se3_t"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0, atol=1e-9)
    cov = np.asarray(want.core.covariance)
    assert np.abs(got.core.covariance - cov).max() <= 1e-8 * np.abs(cov).max()
    for bad, msg in (("cams", "No camera intrinsics provided"), ("obj", "No observations provided")):
        args = [torch.tensor(p[k][:0] if k == bad else p[k]) for k in ARGS]
        with pytest.raises(ValueError, match=msg):
            tbundle.optimize_bundle(*args)


def test_bundle_options_and_configs_keep_the_reference_fields():
    for j, t in ((jbundle.BundleOptions, tbundle.BundleOptions), (jfh.BundleRigConfig, tfh.BundleRigConfig),
                 (jfh.BundlePipelineConfig, tfh.BundlePipelineConfig)):
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    rig = jfh.BundleRigConfig(rig_id="r", sensors=["a"], options=JBundleOptions(optimize_skew=True),
                              min_angle_deg=2.0, initial_target=BT)
    text = jjsonio.to_jsonable(jfh.BundlePipelineConfig(rigs=[rig]))
    got = tjsonio.from_jsonable(json.loads(json.dumps(text)), tfh.BundlePipelineConfig)
    assert tjsonio.to_jsonable(got) == text
    assert tjsonio.to_jsonable(convert.bundle_pipeline_config(jfh.BundlePipelineConfig(rigs=[rig]))) == text


# ------------------------------------------------------------ bundle_batch

C5_OPTS = JBundleOptions(core=JOptimOptions(max_iterations=40, compute_covariance=False))


def _config5(b=4):
    p = chip_smoke.bundle_problems(b, num_obs=8, rows=6, cols=8)
    return p, chip_smoke.bundle_args(p, "cpu")


def test_bundle_batch_matches_jax():
    """One phase, the config-5 shape (one camera, intrinsics fixed)."""
    p, args = _config5()
    b, o = p["bg"].shape[:2]
    want = jax.device_get(jbatched.bundle_batch(
        p["obj"], p["uv"], p["bg"], np.zeros((b, o), int), np.tile(p["intr"][None, None], (b, 1, 1)),
        p["g0"][:, None], p["b0"], opts=C5_OPTS, two_phase=False,
    ))
    got = tbatched.bundle_batch(*args, opts=convert.bundle_options(C5_OPTS), two_phase=False)
    _assert_solves_equal(got, want)


def test_bundle_batch_phased_matches_single(monkeypatch):
    """The JAX package's test_bundle_batch_phased_matches_single: with the
    cap at 2, real lanes flow through the compaction and land on the same
    minimum as one phase."""
    p, args = _config5()
    opts = convert.bundle_options(C5_OPTS)
    one = tbatched.bundle_batch(*args, opts=opts, two_phase=False)
    monkeypatch.setattr(tbatched, "BUNDLE_PHASE_CAP", 2)
    phased = tbatched.bundle_batch(*args, opts=opts, two_phase=True)
    assert bool(one[0].success.all()) and bool(phased[0].success.all())
    assert int(phased[0].iterations.max()) > 2  # past the first phase
    np.testing.assert_allclose(phased[0].cost.numpy(), one[0].cost.numpy(), rtol=1e-8)
    np.testing.assert_allclose(phased[2].numpy(), one[2].numpy(), atol=1e-6)
    np.testing.assert_allclose(phased[3].numpy(), one[3].numpy(), atol=1e-6)
    assert phased[4].shape == one[4].shape


@pytest.mark.parametrize("total", [1, 2, 3, 5])
def test_bundle_batch_keeps_the_budget(monkeypatch, total):
    """The phased schedule never runs more trials than max_iterations,
    also when the budget is at or below the cap (the reference adds a
    one-iteration phase there)."""
    _, args = _config5(2)
    monkeypatch.setattr(tbatched, "BUNDLE_PHASE_CAP", 2)
    opts = tbundle.BundleOptions(core=dataclasses.replace(convert.bundle_options(C5_OPTS).core, max_iterations=total))
    out = tbatched.bundle_batch(*args, opts=opts, two_phase=True)
    assert 0 < int(out[0].iterations.max()) <= total and int(out[0].linearizations.max()) <= total


def test_covariance_forces_one_phase(monkeypatch):
    _, args = _config5(2)
    monkeypatch.setattr(tbatched, "BUNDLE_PHASE_CAP", 2)
    opts = convert.bundle_options(JBundleOptions(core=JOptimOptions(max_iterations=40)))
    phased, one = (tbatched.bundle_batch(*args, opts=opts, two_phase=tp) for tp in (True, False))
    for a, b in zip(phased, one):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert bool(one[5].all())


# -------------------------------------------------------------- the fleets


def _jobs(cls, seeds, cameras, opts_of, given=()):
    jobs = []
    for k, (seed, c) in enumerate(zip(seeds, cameras)):
        s = scene(seed, c=c, o=6)
        common = dict(obj=s["obj"], uv=s["uv"], bg=s["bg"], cam_idx=s["cam_idx"], cameras=s["cams"],
                      he_init=s["g0"], mask=s["mask"].astype(bool), opts=opts_of(k))
        if cls == "fused":
            jobs.append(dict(common, kmtx=s["cams"][s["cam_idx"]][:, :5], target_given=s["b0"],
                             use_given_target=k in given))
        else:
            jobs.append(dict(common, target=s["b0"]))
    return jobs


def _bundle_json(r):
    """A BundleResult as the stage writes it (bundle/<rig>/result)."""
    return {"result": {
        "success": r.core.success, "final_cost": r.core.final_cost, "report": r.core.report,
        "b_se3_t": np.asarray(r.b_se3_t).tolist(), "g_se3_c": np.asarray(r.g_se3_c).tolist(),
        "cameras": np.asarray(r.cameras).tolist(),
        "covariance": None if r.core.covariance is None else np.asarray(r.core.covariance).tolist(),
    }}


@pytest.mark.parametrize("buckets", [1, 2])
def test_bundle_fleets_match_jax(buckets):
    """bundle_fleet and bundle_fused_fleet (one target given, the others
    averaged): one bucket, or two (camera counts and options differ)."""
    opts_a = JBundleOptions(core=JOptimOptions(max_iterations=50))
    opts_b = JBundleOptions(core=JOptimOptions(max_iterations=40, compute_covariance=False))
    seeds, cameras = ((11, 13, 15), (2, 1, 2)) if buckets == 2 else ((11, 15), (2, 2))
    opts_of = (lambda k: opts_a if k != 1 else opts_b) if buckets == 2 else (lambda k: opts_a)
    for kind, jcls, tcls, jfn, tfn in (
        ("plain", jfleet.BundleJob, tfleet.BundleJob, jfleet.bundle_fleet, tfleet.bundle_fleet),
        ("fused", jfleet.FusedBundleJob, tfleet.FusedBundleJob, jfleet.bundle_fused_fleet, tfleet.bundle_fused_fleet),
    ):
        jobs = _jobs(kind, seeds, cameras, opts_of, given=(0,))
        want = jfn([jcls(**j) for j in jobs])
        got = tfn([tcls(**dict(j, opts=convert.bundle_options(j["opts"]))) for j in jobs], "cpu")
        if kind == "fused":
            for (_, w_t), (_, g_t) in zip(want, got):
                np.testing.assert_allclose(g_t, w_t, rtol=0, atol=1e-12)
            want, got = [w for w, _ in want], [g for g, _ in got]
        assert_reports_match([_bundle_json(r) for r in want], [_bundle_json(r) for r in got])
        assert all(r.core.success for r in got)


@pytest.mark.parametrize("buckets", [1, 2])
def test_dlt_and_average_fleets_match_jax(buckets):
    """handeye_dlt_fleet (two buckets: another pose count and angle) and
    average_isometries_fleet (groups of unequal length, padded)."""
    _, bg, ct = chip_smoke.handeye_problems(3, num_poses=6, seed=3)
    ct = ct.copy()
    ct[..., :3, 3] += np.random.default_rng(1).normal(0, 2e-3, ct[..., :3, 3].shape)
    jobs = [(bg[k], ct[k], 1.0) for k in range(3)]
    if buckets == 2:
        jobs[1] = (bg[1, :5], ct[1, :5], 2.0)
    for (wp, wok), (gp, gok) in zip(jfleet.handeye_dlt_fleet(jobs), tfleet.handeye_dlt_fleet(jobs, "cpu")):
        assert gok and wok
        np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-10)
    k = 6 if buckets == 1 else 4
    groups = [list(ct[0] @ bg[0]), list(ct[1, :k] @ bg[1, :k])]
    for w, g in zip(jfleet.average_isometries_fleet(groups), tfleet.average_isometries_fleet(groups, "cpu")):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert tfleet.average_isometries_fleet([], "cpu") == []


# -------------------------------------------------------------- the stage

V_B = 6


def _stage_scene(seed=21):
    """Detections of sensors s0, s1 (a two-camera rig seen from shared
    robot poses) and s3 (its own rig; view 2 has 3 points), V_B robot poses
    each, and the truth."""
    rng = np.random.default_rng(seed)
    cams = {"s0": INTR, "s1": _cameras(2)[1], "s2": INTR, "s3": INTR}
    g = dict(zip(("s0", "s1", "s3"), _hand_eye(rng, 3)))
    bases = {"rig01": [], "rig3": []}
    views = {sid: [] for sid in g}
    for k in range(V_B):
        ct0 = _camera_view(rng)
        bg = BT @ np.linalg.inv(ct0) @ np.linalg.inv(g["s0"])
        bases["rig01"].append(bg)
        views["s0"].append(ct0)
        views["s1"].append(np.linalg.inv(g["s1"]) @ np.linalg.inv(bg) @ BT)
        ct3 = _camera_view(rng)
        bases["rig3"].append(BT @ np.linalg.inv(ct3) @ np.linalg.inv(g["s3"]))
        views["s3"].append(ct3)
    payloads = {}
    for sid, cts in views.items():
        uv = chip_smoke._render(cams[sid], np.stack(cts), GRID, 0.2, rng)
        payload = chip_smoke.detections_payload(sid, GRID, uv)
        for k, img in enumerate(payload["images"]):
            img["file"] = f"{sid}_{k:02d}.png"
        if sid == "s3":
            payload["images"][2]["points"] = payload["images"][2]["points"][:3]
        payloads[sid] = payload
    return payloads, bases, cams, g


def _obs(bases, sensors, views=range(V_B), images=None):
    return [jfh.HandEyeObservationConfig(
        view_id=f"v{k}", base_se3_gripper=bases[k],
        images=images(k) if images else {s: f"{s}_{k:02d}.png" for s in sensors},
    ) for k in views]


def _bundle_rigs(bases):
    cfg = JBundleOptions(core=JOptimOptions(max_iterations=50))
    return [
        # both cameras; hand-eye results or DLT seeds; the target averaged
        jfh.BundleRigConfig(rig_id="r01", sensors=["s0", "s1"], observations=_obs(bases["rig01"], ["s0", "s1"]),
                            options=cfg),
        # no observations of its own: the hand-eye rig's, with a missing
        # image reference, an image not in the dataset and a 3-point view;
        # the target from the config
        jfh.BundleRigConfig(rig_id="r3", sensors=["s3"], options=cfg, initial_target=BT @ DB),
        # one observation and no hand-eye result: identity init
        # (insufficient_observations); a config target, the hand-eye pose
        # frozen, one iteration: optimization_failed
        jfh.BundleRigConfig(rig_id="r0", sensors=["s0"], observations=_obs(bases["rig01"], ["s0"], views=[0]),
                            options=JBundleOptions(core=JOptimOptions(max_iterations=1), optimize_hand_eye=False),
                            initial_target=BT),
        jfh.BundleRigConfig(rig_id="none", sensors=["s0"]),  # no_observations
        jfh.BundleRigConfig(rig_id="r9", sensors=["s0", "s9"],  # missing_intrinsics
                            observations=_obs(bases["rig01"], ["s0", "s9"])),
        jfh.BundleRigConfig(rig_id="r2", sensors=["s2"],  # missing_detections -> no_valid_observations
                            observations=_obs(bases["rig01"], ["s2"])),
    ]


def _he_rigs(bases):
    images = lambda k: {} if k == 0 else {"s3": "nope.png" if k == 1 else f"s3_{k:02d}.png"}  # noqa: E731
    return [jfh.HandEyeRigConfig(rig_id="r3", sensors=["s3"], observations=_obs(bases["rig3"], ["s3"], images=images))]


def _context(jax_side, scene_, rigs, he_results=True, he_rigs=True, intr=("s0", "s1", "s2", "s3")):
    payloads, bases, cams, g = scene_
    det_cls, jsonio = (JDetections, jjsonio) if jax_side else (TDetections, tjsonio)
    ctx = JContext() if jax_side else TContext()
    ctx.dataset = (JDataset if jax_side else TDataset)(
        planar_cameras=[jsonio.from_jsonable(p, det_cls) for sid, p in payloads.items()]
    )
    result, optim, out_cls, he_cls = ((JIntrResult, JOptimResult, JIntrOut, JHandeyeResult) if jax_side
                                      else (TIntrResult, TOptimResult, TIntrOut, THandeyeResult))
    for sid in intr:
        ctx.intrinsic_results[sid] = out_cls(refine_result=result(
            core=optim(success=True), camera=cams[sid].copy(), c_se3_t=np.zeros((V_B, 4, 4)),
            view_errors=np.zeros(V_B),
        ))
    if he_results:
        for rig, sensors in (("r01", ("s0", "s1")), ("r3", ("s3",))):
            ctx.handeye_results[rig] = {s: he_cls(core=optim(success=True), g_se3_c=g[s] @ DG) for s in sensors}
    if he_rigs:
        cfg = jfh.HandEyePipelineConfig(rigs=_he_rigs(bases))
        ctx.set_handeye_config(cfg if jax_side else convert.handeye_pipeline_config(cfg))
    if rigs is not None:
        cfg = jfh.BundlePipelineConfig(rigs=rigs)
        ctx.set_bundle_config(cfg if jax_side else convert.bundle_pipeline_config(cfg))
    return ctx


def _run_stage(jax_side, scene_, rigs, **kw):
    ctx = _context(jax_side, scene_, rigs, **kw)
    result = (JStage() if jax_side else TStage("cpu")).run(ctx)
    return json.loads(json.dumps({"success": result.success, "summary": result.summary, "artifacts": ctx.artifacts}))


@pytest.fixture(scope="module")
def stage_scene():
    return _stage_scene()


@pytest.mark.parametrize("path", ["fused", "staged"])
def test_bundle_stage_matches_jax(stage_scene, path, monkeypatch):
    """Every rig-level and per-sensor status. With hand-eye results for
    r01 and r3 no rig needs a DLT seed and the fused call runs; without
    them r01 and r3 are seeded by DLT on the staged path."""
    rigs = _bundle_rigs(stage_scene[1])
    calls = []
    for name in ("bundle_fused_fleet", "bundle_fleet"):
        fn = getattr(tfleet, name)
        monkeypatch.setattr(tfleet, name, lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    want, got = (_run_stage(side, stage_scene, rigs, he_results=path == "fused") for side in (True, False))
    assert calls == (["bundle_fused_fleet"] if path == "fused" else ["bundle_fleet"])
    summary = {r["rig_id"]: r for r in got["summary"]["rigs"]}
    assert [r["status"] for r in got["summary"]["rigs"]] == [
        "ok", "ok", "optimization_failed", "no_observations", "missing_intrinsics", "no_valid_observations"]
    source = "handeye" if path == "fused" else "dlt"
    assert [e["source"] for e in summary["r01"]["handeye_initialization"]] == [source, source]
    assert summary["r0"]["handeye_initialization"] == [
        {"sensor_id": "s0", "source": "identity", "success": False, "error": "insufficient_observations"}]
    assert summary["r01"]["initial_target_source"] == "estimated"
    assert summary["r3"]["initial_target_source"] == "config"
    assert summary["r3"]["observations"] == {"requested": V_B, "used": V_B - 3}
    assert [v["sensors"][0]["status"] for v in summary["r3"]["views"][:3]] == [
        "missing_image_reference", "image_not_in_dataset", "insufficient_points"]
    assert {v["sensors"][0]["status"] for v in summary["r2"]["views"]} == {"missing_detections"}
    assert got["summary"]["status"] == "partial_success" and not got["success"]
    assert_reports_match(want, got)
    g = np.array(got["artifacts"]["bundle"]["r01"]["result"]["g_se3_c"])
    tra, rot = chip_smoke.pose_errors(g, np.stack([stage_scene[3]["s0"], stage_scene[3]["s1"]]))
    assert tra < 5e-3 and rot < 0.5


@pytest.mark.parametrize("case", ["no_intrinsics", "no_config", "no_rigs"])
def test_bundle_stage_early_statuses_match_jax(stage_scene, case):
    rigs = {"no_intrinsics": _bundle_rigs(stage_scene[1])[:1], "no_config": None, "no_rigs": []}[case]
    intr = () if case == "no_intrinsics" else ("s0",)
    want, got = (_run_stage(side, stage_scene, rigs, intr=intr) for side in (True, False))
    assert got["summary"]["status"] == {
        "no_intrinsics": "waiting_for_intrinsic_stage", "no_config": "missing_config", "no_rigs": "no_rigs_configured",
    }[case]
    assert_reports_match(want, got)


def test_stage_lets_a_failing_batched_solve_raise(stage_scene, monkeypatch):
    def broken(jobs, device):
        raise RuntimeError("batched solve failed")

    monkeypatch.setattr(tfleet, "bundle_fused_fleet", broken)
    with pytest.raises(RuntimeError, match="batched solve failed"):
        _run_stage(False, stage_scene, _bundle_rigs(stage_scene[1])[:1])


# ----------------------------------------------------------------- the app


@pytest.fixture(scope="module")
def jax_app_artifacts(tmp_path_factory):
    """The JAX app on the committed example input, run once."""
    out = tmp_path_factory.mktemp("jax") / "jax.json"
    assert japp.main(["--input", str(INPUT), "--output", str(out)]) == 0
    return chip_smoke.without_durations(json.loads(out.read_text()))


def test_bundle_pipeline_app_matches_jax(tmp_path, jax_app_artifacts):
    """All four stages' worth on the example data (no stereo): the same
    artifacts as the JAX app's, stage wall times aside; the bundle g_se3_c
    within 1 mm of the generator's hand-eye translation."""
    out = tmp_path / "port.json"
    assert tapp.main(["--input", str(INPUT), "--output", str(out), "--device", "cpu"]) == 0
    got = chip_smoke.without_durations(json.loads(out.read_text()))
    assert [s["name"] for s in got["pipeline_summary"]["stages"]] == ["intrinsics", "hand_eye", "bundle"]
    assert_reports_match(jax_app_artifacts, got)
    g = np.array(got["bundle"]["rig0"]["result"]["g_se3_c"][0])
    np.testing.assert_allclose(g[:3, 3], [0.02, -0.03, 0.05], atol=1e-3)


def _absolute_input(tmp_path, **changes):
    d = json.loads(INPUT.read_text())
    d["planar_intrinsics_config"] = str(INPUT.parent / d["planar_intrinsics_config"])
    for e in d["planar_detections"]:
        e["path"] = str(INPUT.parent / e["path"])
    d.update(changes)
    path = tmp_path / "input.json"
    path.write_text(json.dumps(d))
    return path, d


@pytest.mark.parametrize("section,stages", [
    ("empty", ["intrinsics", "hand_eye"]), ("positional", ["intrinsics", "hand_eye", "bundle"]),
])
def test_bundle_section_keys(tmp_path, section, stages):
    """An empty bundle section is no bundle stage, as in the reference;
    the section's positional key is read too."""
    rigs = json.loads(INPUT.read_text())["bundle"]["rigs"]
    path, _ = _absolute_input(tmp_path, bundle={"rigs": []} if section == "empty" else {"field_0": rigs})
    out = tmp_path / "out.json"
    assert tapp.main(["--input", str(path), "--output", str(out), "--device", "cpu"]) == 0
    assert [s["name"] for s in json.loads(out.read_text())["pipeline_summary"]["stages"]] == stages


def test_failing_bundle_solve_fails_the_app(tmp_path, monkeypatch, capsys):
    """A batched bundle solve that raises fails the run; no staged or
    serial re-solve hides it."""
    def broken(jobs, device):
        raise RuntimeError("bundle solve failed on the device")

    monkeypatch.setattr(tfleet, "bundle_fused_fleet", broken)
    monkeypatch.setattr(tfleet, "bundle_fleet", lambda *a: pytest.fail("staged re-solve"))
    out = tmp_path / "out.json"
    assert tapp.main(["--input", str(INPUT), "--output", str(out), "--device", "cpu"]) == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == (
        "Calibration pipeline failed: bundle solve failed on the device"
    )
    assert not out.exists()
