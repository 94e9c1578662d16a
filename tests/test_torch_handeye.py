"""Port equivalence of the hand-eye slice, CPU, float64, each piece against
its JAX counterpart on the same numpy inputs: motion pairs and filter
weights, the Tsai-Lenz DLT seed, both rotation residuals and both analytic
Jacobians (against JAX's jacfwd), ``optimize_handeye_device`` and
``handeye_batch``, the three fleet functions, ``HandEyeCalibrationStage``
with every status path, the ``bundle_pipeline`` app on an input without a
bundle section (the bundle stage: tests/test_torch_bundle.py); and the
app's refusal of a missing card.

Data: the JAX package's config-4 generator (benchmarks/problems.py::
handeye_problems, restated without JAX in chip_smoke.py) with 12 poses,
camera poses perturbed by 2 mm so the minimum has a nonzero cost; rendered
detections for the stage.

Bars: pairs, weights and the seed 1e-12 absolute (the weights exactly);
Jacobians 1e-10 relative to max(1, |entry|); solves with iterations,
linearizations and termination exactly equal per rig, cost 1e-10 relative,
X 1e-10 absolute, covariance 1e-8 relative to its largest entry; stage and
app artifacts within ``torch_helpers.report_tolerance``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import synth
from calibration_tpu.apps import bundle_pipeline as japp
from calibration_tpu.io import jsonio as jjsonio
from calibration_tpu.ops import handeye_linear as jhel
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.optim import handeye as jhe
from calibration_tpu.optim.core import OptimResult as JOptimResult
from calibration_tpu.optim.intrinsics import IntrinsicsOptimizationResult as JIntrResult
from calibration_tpu.parallel import batched as jbatched
from calibration_tpu.pipeline import HandEyeCalibrationStage as JStage
from calibration_tpu.pipeline import PipelineContext as JContext
from calibration_tpu.pipeline import fleet as jfleet
from calibration_tpu.pipeline.dataset import CalibrationDataset as JDataset
from calibration_tpu.pipeline.dataset import PlanarDetections as JDetections
from calibration_tpu.pipeline.facades import handeye as jfh
from calibration_tpu.pipeline.facades.intrinsics import IntrinsicCalibrationOutputs as JIntrOut
from calibration_tpu_torch import convert
from calibration_tpu_torch.apps import bundle_pipeline as tapp
from calibration_tpu_torch.io import jsonio as tjsonio
from calibration_tpu_torch.ops import handeye_linear as thel
from calibration_tpu_torch.optim import handeye as the
from calibration_tpu_torch.optim.core import OptimResult as TOptimResult
from calibration_tpu_torch.optim.intrinsics import IntrinsicsOptimizationResult as TIntrResult
from calibration_tpu_torch.parallel import batched as tbatched
from calibration_tpu_torch.pipeline import HandEyeCalibrationStage as TStage
from calibration_tpu_torch.pipeline import PipelineContext as TContext
from calibration_tpu_torch.pipeline import fleet as tfleet
from calibration_tpu_torch.pipeline.dataset import CalibrationDataset as TDataset
from calibration_tpu_torch.pipeline.dataset import PlanarDetections as TDetections
from calibration_tpu_torch.pipeline.facades import handeye as tfh
from calibration_tpu_torch.pipeline.facades.intrinsics import IntrinsicCalibrationOutputs as TIntrOut
from torch_helpers import assert_reports_match, one_torch_thread, t64  # noqa: F401

B, P = 4, 12
INPUT = "examples/data/bundle_input.json"


def rigs(seed=5):
    g, bg, ct = chip_smoke.handeye_problems(B, num_poses=P, seed=seed)
    ct = ct.copy()
    ct[..., :3, 3] += np.random.default_rng(1).normal(0, 2e-3, ct[..., :3, 3].shape)
    return g, bg, ct


def _jax_pairs(bg, ct, ang):
    return jax.vmap(lambda b, c: jhel.build_all_pairs(b, c, ang))(jnp.asarray(bg), jnp.asarray(ct))


def test_pairs_weights_and_seed_match_jax():
    g, bg, ct = rigs()
    bg[0, 3] = bg[0, 2]  # a zero-motion pair and near-duplicates: filtered
    ct[0, 3] = ct[0, 2]
    want = jax.device_get(_jax_pairs(bg, ct, 2.0))
    got = thel.build_all_pairs(t64(bg), t64(ct), 2.0)
    for name, w, t in zip(thel.MotionPairs._fields, want, got):
        np.testing.assert_allclose(t.numpy(), w, rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(got.weight.numpy(), want.weight)
    assert 0 < got.weight.sum() < B * P * (P - 1) / 2
    ii, jj = thel.pair_indices(P)
    j_ii, j_jj = jhel.pair_indices(P)
    np.testing.assert_array_equal(ii.numpy(), np.asarray(j_ii))
    np.testing.assert_array_equal(jj.numpy(), np.asarray(j_jj))
    # reweighting the stored quaternions, and a pose mask
    re = thel.reweight(got, 0.5)
    np.testing.assert_array_equal(re.weight.numpy(), np.asarray(jax.vmap(lambda p: jhel.reweight(p, 0.5).weight)(want)))
    pm = np.ones((B, P), bool)
    pm[1, 5] = False
    masked = thel.build_all_pairs(t64(bg), t64(ct), 2.0, pose_mask=torch.tensor(pm))
    want_m = jax.vmap(lambda b, c, m: jhel.build_all_pairs(b, c, 2.0, pose_mask=m).weight)(bg, ct, pm)
    np.testing.assert_array_equal(masked.weight.numpy(), np.asarray(want_m))
    # the seed
    pose_w, ok_w = jax.vmap(jhel.estimate_handeye_dlt_pairs)(want)
    pose_t, ok_t = thel.estimate_handeye_dlt_pairs(got)
    np.testing.assert_allclose(pose_t.numpy(), pose_w, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ok_t.numpy(), ok_w)
    assert synth.rot_err_deg(pose_t[1].numpy(), g[1]) < 0.5
    # the matrix-input modified Rodrigues vector equals 2 vec(q)
    mr = thel._modified_rodrigues(got.rot_a)
    np.testing.assert_allclose(mr.numpy(), np.asarray(jhel._modified_rodrigues(jnp.asarray(want.rot_a))), atol=1e-12)
    np.testing.assert_allclose(mr.numpy(), 2.0 * got.q_a[..., 1:].numpy(), atol=1e-12)


@pytest.mark.parametrize("rot_residual", ["quat", "log"])
def test_residuals_and_analytic_jacobians_match_jax(rot_residual):
    """At an iterate off the solution (a unit quaternion, as the LM's
    retraction keeps it): residuals 1e-12, the analytic Jacobians against
    JAX's jacfwd of the retracted residual at 1e-10."""
    g, bg, ct = rigs()
    pairs_j = jax.device_get(_jax_pairs(bg, ct, 1.0))
    pairs_t = thel.build_all_pairs(t64(bg), t64(ct), 1.0)
    q = np.array([0.9, 0.1, -0.2, 0.3])
    x = np.tile(np.concatenate([q / np.linalg.norm(q), [0.01, 0.02, -0.03]]), (B, 1))
    res_t, jac_t = the._residual_fns(rot_residual, True)
    got_r = res_t(t64(x), *pairs_t).numpy()
    got_j = jac_t(t64(x), *pairs_t).numpy()
    for i in range(2):
        pj = jhel.MotionPairs(*(jnp.asarray(a[i]) for a in pairs_j))
        if rot_residual == "quat":
            res_j = lambda v: jhe._residual_quat(v, pj, pj.q_a, pj.q_b)  # noqa: E731
        else:
            res_j = lambda v: jhe._residual(v, pj)  # noqa: E731
        np.testing.assert_allclose(got_r[i], np.asarray(res_j(jnp.asarray(x[i]))), rtol=0, atol=1e-12)
        want = np.asarray(jax.jacfwd(lambda d: res_j(jhe._MANIFOLD.retract(jnp.asarray(x[i]), d)))(jnp.zeros(6)))
        scale = np.maximum(1.0, np.abs(want))
        np.testing.assert_allclose(got_j[i] / scale, want / scale, atol=1e-10)


def _assert_solves_equal(got, want):
    for name in ("iterations", "linearizations", "termination", "success"):
        np.testing.assert_array_equal(getattr(got[0], name).numpy(), np.asarray(getattr(want[0], name)), err_msg=name)
    np.testing.assert_allclose(got[0].cost.numpy(), want[0].cost, rtol=1e-10)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    scale = np.maximum(np.abs(want[2]).max(axis=(-2, -1)), 1e-300)
    assert np.all(np.abs(got[2].numpy() - want[2]).max(axis=(-2, -1)) <= 1e-8 * scale)


@pytest.mark.parametrize(
    "rot_residual,analytic,huber",
    [("quat", True, 1.0), ("log", True, 1e-3), ("quat", False, 1e-3)],
    ids=["quat", "log_huber_tails", "quat_jacfwd_huber_tails"],
)
def test_handeye_batch_matches_jax(rot_residual, analytic, huber):
    """handeye_batch (covariance on): the DLT seed from the pairs, then the
    LM on the same pairs; with a tiny Huber delta every pair block is in
    the tail. The jacfwd case runs optimize_handeye_device on those pairs
    with analytic_jac=False."""
    g, bg, ct = rigs()
    jopts = JOptimOptions(max_iterations=50, huber_delta=huber)
    topts = convert.optim_options(jopts)
    if analytic:
        want = jax.device_get(jbatched.handeye_batch(jnp.asarray(bg), jnp.asarray(ct), options=jopts, rot_residual=rot_residual))
        got = tbatched.handeye_batch(t64(bg), t64(ct), options=topts, rot_residual=rot_residual)
    else:
        pairs_j = _jax_pairs(bg, ct, 1.0)
        init_j, _ = jax.vmap(jhel.estimate_handeye_dlt_pairs)(pairs_j)
        want = jax.device_get(jax.vmap(
            lambda p, x0: jhe.optimize_handeye_device(p, x0, jopts, analytic_jac=False, rot_residual=rot_residual)
        )(pairs_j, init_j))
        pairs_t = convert.motion_pairs(jax.device_get(pairs_j), "cpu")
        got = the.optimize_handeye_device(pairs_t, t64(init_j), topts, analytic_jac=False, rot_residual=rot_residual)
    _assert_solves_equal(got, want)
    assert bool(got[0].success.all()) and bool(got[3].all())
    assert max(synth.rot_err_deg(got[1][i].numpy(), g[i]) for i in range(B)) < 0.2  # 2 mm camera noise


def test_host_wrappers_match_jax():
    """optimize_handeye (pairs rebuilt at 0.5 deg) and
    estimate_and_optimize_handeye, one rig each, covariance on."""
    g, bg, ct = rigs()
    jopts = JOptimOptions(max_iterations=50)
    topts = convert.optim_options(jopts)
    init = g[0] @ chip_smoke._pose([0.01, -0.008, 0.012], [0.004, -0.003, 0.002])
    pairs = [
        (jhe.optimize_handeye(bg[0], ct[0], init, jopts), the.optimize_handeye(t64(bg[0]), t64(ct[0]), t64(init), topts)),
        (jhe.estimate_and_optimize_handeye(bg[0], ct[0], 1.0, jopts),
         the.estimate_and_optimize_handeye(t64(bg[0]), t64(ct[0]), 1.0, topts)),
    ]
    for want, got in pairs:
        assert got.core.report == want.core.report and got.core.success
        np.testing.assert_allclose(got.core.final_cost, want.core.final_cost, rtol=1e-10)
        np.testing.assert_allclose(got.g_se3_c, want.g_se3_c, rtol=0, atol=1e-10)
        cov_w = np.asarray(want.core.covariance)
        assert np.abs(got.core.covariance - cov_w).max() <= 1e-8 * np.abs(cov_w).max()


def _result_json(r):
    return {"success": r.core.success, "final_cost": r.core.final_cost, "report": r.core.report,
            "g_se3_c": np.asarray(r.g_se3_c).tolist(),
            "covariance": None if r.core.covariance is None else np.asarray(r.core.covariance).tolist()}


def test_fleet_functions_match_jax():
    """planar_pose_fleet (two point counts), handeye_fleet and
    planar_handeye_fleet (two buckets: another min angle and options; a
    short view padded and masked): the JAX fleets' results, in job order."""
    g, bg, ct = rigs()
    intr = synth.default_camera()
    grid = synth.make_target_grid(4, 5, 0.04)
    rng = np.random.default_rng(3)
    views = [(grid, synth.render_pixels(intr, ct[r], grid, noise=0.1, rng=rng)) for r in range(B)]
    opts_a, opts_b = JOptimOptions(max_iterations=50), JOptimOptions(max_iterations=40, compute_covariance=False)

    pose_jobs = [(grid, views[0][1][k], intr[:5]) for k in range(3)] + [(grid[:12], views[1][1][0][:12], intr[:5])]
    want_p, got_p = jfleet.planar_pose_fleet(pose_jobs), tfleet.planar_pose_fleet(pose_jobs, "cpu")
    for w, t in zip(want_p, got_p):
        np.testing.assert_allclose(t, w, rtol=0, atol=1e-9)

    he_jobs = [(bg[r], ct[r], 1.0, opts_b) for r in range(B)]
    t_jobs = [(b, c, a, convert.optim_options(o)) for b, c, a, o in he_jobs]
    assert_reports_match([_result_json(r) for r in jfleet.handeye_fleet(he_jobs)],
                         [_result_json(r) for r in tfleet.handeye_fleet(t_jobs, "cpu")])

    ph_jobs = [
        ([o for o in [grid] * P], list(views[r][1]), intr[:5], bg[r], 1.0 if r != 2 else 2.0,
         opts_a if r != 2 else opts_b)
        for r in range(B)
    ]
    ph_jobs[1][0][4], ph_jobs[1][1][4] = grid[:15], ph_jobs[1][1][4][:15]  # a short view: masked padding
    want = jfleet.planar_handeye_fleet(ph_jobs)
    got = tfleet.planar_handeye_fleet([j[:5] + (convert.optim_options(j[5]),) for j in ph_jobs], "cpu")
    assert_reports_match([_result_json(r) for r in want], [_result_json(r) for r in got])
    assert all(r.core.success for r in got)


# ------------------------------------------------------------------ the stage

V_HE = 8
GRID = synth.make_target_grid(5, 6, 0.04)
INTR = synth.default_camera()


def _scene(seed=7):
    """Detections payloads of sensors s0, s1 and s3 (s1's view 2 has 3
    points) and V_HE robot poses seen by all of them."""
    rng = np.random.default_rng(seed)
    g = synth.euler_pose(0.1, -0.2, 0.15, [0.02, -0.03, 0.05])
    bt = synth.euler_pose(0.05, 0.03, -0.08, [0.4, -0.1, 0.2])
    payloads, bases = {}, None
    for sid in ("s0", "s1", "s3"):
        c = [synth.euler_pose(*rng.uniform(-0.4, 0.4, 3), rng.uniform(-0.08, 0.08, 3) + [0, 0, 0.7])
             for _ in range(V_HE)]
        uv = synth.render_pixels(INTR, np.stack(c), GRID, noise=0.1, rng=rng)
        if bases is None:
            bases = [bt @ np.linalg.inv(ci) @ np.linalg.inv(g) for ci in c]
        keep = {2: 3} if sid == "s1" else {}
        payloads[sid] = {
            "image_directory": "synthetic", "feature_type": "synthetic_grid", "algo_version": "1",
            "params_hash": "synthetic", "sensor_id": sid, "tags": ["synthetic"], "metadata": {}, "source_file": "",
            "images": [{"file": f"{sid}_{v:02d}.png", "points": [
                {"x": float(uv[v, j, 0]), "y": float(uv[v, j, 1]), "id": j, "local_x": float(GRID[j, 0]),
                 "local_y": float(GRID[j, 1]), "local_z": 0.0} for j in range(keep.get(v, GRID.shape[0]))]}
                for v in range(V_HE)],
        }
    return payloads, bases


def _rig(rig_id, sensors, bases, views=range(V_HE), images=None, **kw):
    obs = [jfh.HandEyeObservationConfig(
        view_id=f"v{k}", base_se3_gripper=bases[k],
        images=images(k) if images else {s: f"{s}_{k:02d}.png" for s in sensors},
    ) for k in views]
    return jfh.HandEyeRigConfig(rig_id=rig_id, sensors=sensors, observations=obs, **kw)


def _rigs(bases):
    return [
        # s0 ok; s2 has intrinsics but no detections; s9 has neither ->
        # partial_success
        _rig("r0", ["s0", "s2", "s9"], bases),
        # a missing image reference, an image not in the dataset, s1's
        # 3-point view, and another bucket (min angle, covariance off)
        _rig("r1", ["s1"], bases, images=lambda k: {} if k == 0 else {"s1": "nope.png" if k == 1 else f"s1_{k:02d}.png"},
             min_angle_deg=2.0, options=JOptimOptions(compute_covariance=False)),
        _rig("r2", ["s0"], bases, views=[0]),  # insufficient_observations
        _rig("r3", ["s0"], bases, views=[]),  # no_observations
        # two rigs sharing the empty rig id: the all-failing one stays failed
        _rig("", ["s3"], bases),
        _rig("", ["ghost"], bases),
    ]


def _context(jax_side, payloads, rigs, intr_sensors):
    det_cls, jsonio = (JDetections, jjsonio) if jax_side else (TDetections, tjsonio)
    ctx = JContext() if jax_side else TContext()
    ctx.dataset = (JDataset if jax_side else TDataset)(
        planar_cameras=[jsonio.from_jsonable(p, det_cls) for p in payloads.values()]
    )
    result, optim, out_cls = (JIntrResult, JOptimResult, JIntrOut) if jax_side else (TIntrResult, TOptimResult, TIntrOut)
    for sid in intr_sensors:
        ctx.intrinsic_results[sid] = out_cls(refine_result=result(
            core=optim(success=True), camera=INTR.copy(), c_se3_t=np.zeros((V_HE, 4, 4)), view_errors=np.zeros(V_HE)
        ))
    if rigs is not None:
        cfg = jfh.HandEyePipelineConfig(rigs=rigs)
        ctx.set_handeye_config(cfg if jax_side else convert.handeye_pipeline_config(cfg))
    return ctx


def _run_stage(jax_side, payloads, rigs, intr_sensors):
    """The stage's result and artifacts, as the JSON an app writes."""
    ctx = _context(jax_side, payloads, rigs, intr_sensors)
    result = (JStage() if jax_side else TStage("cpu")).run(ctx)
    return json.loads(json.dumps({"success": result.success, "summary": result.summary, "artifacts": ctx.artifacts}))


def test_handeye_stage_matches_jax():
    payloads, bases = _scene()
    rigs = _rigs(bases)
    want, got = (_run_stage(side, payloads, rigs, ["s0", "s1", "s2", "s3"]) for side in (True, False))
    statuses = [[s["status"] for s in r["sensor_reports"]] for r in got["summary"]["rigs"]]
    assert statuses == [
        ["ok", "missing_detections", "missing_intrinsics"], ["ok"], ["insufficient_observations"],
        ["no_observations"], ["ok"], ["missing_intrinsics"],
    ]
    assert [r["status"] for r in got["summary"]["rigs"]] == ["partial_success", "ok", "failed", "failed", "ok", "failed"]
    views = got["summary"]["rigs"][1]["sensor_reports"][0]["views"]
    assert [v.get("status") for v in views[:3]] == ["missing_image_reference", "image_not_in_dataset", "insufficient_points"]
    assert got["summary"]["status"] == "partial_success" and not got["success"]
    assert_reports_match(want, got)


@pytest.mark.parametrize("case", ["no_intrinsics", "no_config", "no_rigs"])
def test_handeye_stage_early_statuses_match_jax(case):
    payloads, bases = _scene()
    rigs = {"no_intrinsics": _rigs(bases)[:1], "no_config": None, "no_rigs": []}[case]
    intr = [] if case == "no_intrinsics" else ["s0"]
    want, got = (_run_stage(side, payloads, rigs, intr) for side in (True, False))
    assert got["summary"]["status"] == {
        "no_intrinsics": "waiting_for_intrinsic_stage", "no_config": "missing_config", "no_rigs": "no_rigs_configured",
    }[case]
    assert_reports_match(want, got)


def test_stage_lets_a_failing_batched_solve_raise(monkeypatch):
    payloads, bases = _scene()

    def broken(jobs, device):
        raise RuntimeError("batched solve failed")

    monkeypatch.setattr(tfleet, "planar_handeye_fleet", broken)
    with pytest.raises(RuntimeError, match="batched solve failed"):
        _run_stage(False, payloads, _rigs(bases)[:1], ["s0"])


def test_handeye_config_round_trips_through_json():
    """The port's configs read the JAX configs' JSON (named and positional
    keys) and write the same JSON."""
    _, bases = _scene()
    cfg = jfh.HandEyePipelineConfig(rigs=_rigs(bases)[:2])
    text = jjsonio.to_jsonable(cfg)
    got = tjsonio.from_jsonable(json.loads(json.dumps(text)), tfh.HandEyePipelineConfig)
    assert tjsonio.to_jsonable(got) == text
    assert tjsonio.to_jsonable(convert.handeye_pipeline_config(cfg)) == text
    import dataclasses

    for j, t in ((jfh.HandEyeObservationConfig, tfh.HandEyeObservationConfig),
                 (jfh.HandEyeRigConfig, tfh.HandEyeRigConfig), (jfh.HandEyePipelineConfig, tfh.HandEyePipelineConfig)):
        assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


# -------------------------------------------------------------------- the app


def _input_without_bundle(tmp_path):
    """The committed example input, its paths made absolute, without its
    bundle section."""
    from pathlib import Path

    d = json.loads(Path(INPUT).read_text())
    base = Path(INPUT).resolve().parent
    d["planar_intrinsics_config"] = str(base / d["planar_intrinsics_config"])
    for e in d["planar_detections"]:
        e["path"] = str(base / e["path"])
    bundle = d.pop("bundle")
    path = tmp_path / "input.json"
    path.write_text(json.dumps(d))
    return path, d, bundle


def test_bundle_pipeline_app_matches_jax(tmp_path):
    """Intrinsics then hand-eye on the example data: the same artifacts as
    the JAX app's (stage wall times aside), the rig's status ok."""
    path, _, _ = _input_without_bundle(tmp_path)
    assert japp.main(["--input", str(path), "--output", str(tmp_path / "jax.json")]) == 0
    assert tapp.main(["--input", str(path), "--output", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    want, got = (chip_smoke.without_durations(json.loads((tmp_path / f"{w}.json").read_text())) for w in ("jax", "port"))
    assert [s["name"] for s in got["pipeline_summary"]["stages"]] == ["intrinsics", "hand_eye"]
    assert_reports_match(want, got)
    assert got["hand_eye"]["rig0"]["sensors"]["cam0"]["status"] == "ok"


def test_bundle_pipeline_refuses_a_missing_card(tmp_path, monkeypatch, capsys):
    path, _, _ = _input_without_bundle(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tapp.main(["--input", str(path), "--output", str(tmp_path / "o.json"), "--device", "cuda"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("Calibration pipeline failed: ") and "cuda" in err[-1]
