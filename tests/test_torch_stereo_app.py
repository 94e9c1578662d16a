"""Port equivalence of the stereo / multi-camera front end, CPU, float64:
``StereoCalibrationFacade`` (``calibrate`` and ``calibrate_many``),
``MultiCameraCalibrationFacade.calibrate_many``, ``StereoCalibrationStage``
with every status path, and the ``intrinsic_extrinsic_pipeline`` app on the
committed example data, each against its JAX counterpart on the same
inputs.

Bars (``torch_helpers.report_tolerance``): the same keys at every level,
equal non-floats (statuses, counts, LM report text), the seed 1e-9
relative, refined cameras and poses 1e-6 relative with a 1e-9 absolute
floor, final costs 1e-7 relative; the covariance 1e-6 relative to its
largest entry. The app's artifacts also pass the accuracy checks of the
repository's verify recipe.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import chip_smoke
import synth
from calibration_tpu.apps import intrinsic_extrinsic_pipeline as japp
from calibration_tpu.io import jsonio as jjsonio
from calibration_tpu.optim import ExtrinsicOptions as JExtrinsicOptions
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.optim.core import OptimResult as JOptimResult
from calibration_tpu.optim.intrinsics import IntrinsicsOptimizationResult as JIntrResult
from calibration_tpu.pipeline import PipelineContext as JContext
from calibration_tpu.pipeline import StereoCalibrationStage as JStereoStage
from calibration_tpu.pipeline.dataset import CalibrationDataset as JDataset
from calibration_tpu.pipeline.dataset import PlanarDetections as JDetections
from calibration_tpu.pipeline.facades import extrinsics as jfx
from calibration_tpu.pipeline.facades.intrinsics import IntrinsicCalibrationOutputs as JIntrOut
from calibration_tpu_torch import convert
from calibration_tpu_torch.apps import intrinsic_extrinsic_pipeline as tapp
from calibration_tpu_torch.io import jsonio as tjsonio
from calibration_tpu_torch.optim.core import OptimResult as TOptimResult
from calibration_tpu_torch.optim.intrinsics import IntrinsicsOptimizationResult as TIntrResult
from calibration_tpu_torch.pipeline import PipelineContext as TContext
from calibration_tpu_torch.pipeline import StereoCalibrationStage as TStereoStage
from calibration_tpu_torch.pipeline import fleet as tfleet
from calibration_tpu_torch.pipeline.dataset import CalibrationDataset as TDataset
from calibration_tpu_torch.pipeline.dataset import PlanarDetections as TDetections
from calibration_tpu_torch.pipeline.facades import extrinsics as tfx
from calibration_tpu_torch.pipeline.facades.intrinsics import IntrinsicCalibrationOutputs as TIntrOut
from torch_helpers import assert_reports_match, one_torch_thread  # noqa: F401

INPUT = "examples/data/pipeline_input.json"
CAM1_T = [-0.2, 0.0, 0.02]  # the example data's stereo offset (examples/generate_synthetic.py)
OFFSETS = {
    "s0": np.eye(4),
    "s1": synth.euler_pose(0.02, -0.3, 0.01, [-0.2, 0.0, 0.02]),
    "s2": synth.euler_pose(-0.01, 0.25, -0.02, [0.18, 0.03, -0.01]),
}
INTR = synth.default_camera()
V = 6


def _payload(sensor_id, uv, grid, drop=None):
    """A detections payload in the committed format; ``drop`` maps a view
    index to the number of points it keeps."""
    images = []
    for v in range(uv.shape[0]):
        keep = (drop or {}).get(v, grid.shape[0])
        images.append({
            "file": f"img_{v:03d}.png",
            "points": [
                {"x": float(uv[v, j, 0]), "y": float(uv[v, j, 1]), "id": j,
                 "local_x": float(grid[j, 0]), "local_y": float(grid[j, 1]), "local_z": 0.0}
                for j in range(keep)
            ],
        })
    return {"image_directory": "synthetic", "feature_type": "synthetic_grid", "algo_version": "1",
            "params_hash": "synthetic", "sensor_id": sensor_id, "tags": ["synthetic"],
            "metadata": {}, "source_file": "", "images": images}


def _scene(seed=2):
    """Payloads of sensors s0..s2 watching V views of a 6x8 grid (0.2 px
    noise); s1 keeps 3 points in view 4 (an insufficient view)."""
    rng = np.random.default_rng(seed)
    grid = synth.make_target_grid(6, 8, 0.04)
    poses = synth.circle_views(V, dist=1.0)
    out = {}
    for sid, off in OFFSETS.items():
        uv = synth.render_pixels(INTR, np.einsum("ij,vjk->vik", off, poses), grid, noise=0.2, rng=rng)
        out[sid] = _payload(sid, uv, grid, drop={4: 3} if sid == "s1" else None)
    return out


class Side:
    """One package's types, so a test builds the same inputs for both."""

    def __init__(self, jax_side):
        self.jax = jax_side
        self.fx = jfx if jax_side else tfx
        self.jsonio = jjsonio if jax_side else tjsonio
        self.detections_cls = JDetections if jax_side else TDetections

    def detections(self, payloads):
        return {sid: self.jsonio.from_jsonable(p, self.detections_cls) for sid, p in payloads.items()}

    def intrinsics(self, sensors):
        result, optim = (JIntrResult, JOptimResult) if self.jax else (TIntrResult, TOptimResult)
        out_cls = JIntrOut if self.jax else TIntrOut
        return {
            sid: out_cls(refine_result=result(
                core=optim(success=True), camera=INTR.copy(), c_se3_t=np.zeros((V, 4, 4)), view_errors=np.zeros(V)
            ))
            for sid in sensors
        }

    def options(self, **core):
        jopts = JExtrinsicOptions(core=JOptimOptions(**core))
        return jopts if self.jax else convert.extrinsic_options(jopts)

    def facade(self, kind):
        cls = getattr(self.fx, kind)
        return cls() if self.jax else cls("cpu")


SIDES = (Side(True), Side(False))


def _run_json(run):
    """A facade run result in the stage artifact's layout."""
    if isinstance(run, Exception):
        return {"error": str(run)}
    out = {k: getattr(run, k) for k in ("success", "requested_views", "used_views")}
    out["views"] = [dataclasses.asdict(v) for v in getattr(run, "view_summaries", [])]
    out["initial_guess"] = {k: np.asarray(getattr(run.initial_guess, k)).tolist() for k in ("c_se3_r", "r_se3_t")}
    if run.optimization is not None:
        opt = run.optimization
        out["optimization"] = {
            "success": opt.core.success, "final_cost": opt.core.final_cost, "report": opt.core.report,
            **{k: np.asarray(getattr(opt, k)).tolist() for k in ("cameras", "c_se3_r", "r_se3_t")},
        }
    return out


def _stereo_cfg(side, pair_id, ref, tgt, views, **core):
    return side.fx.StereoPairConfig(
        pair_id=pair_id, reference_sensor=ref, target_sensor=tgt,
        views=[side.fx.StereoViewSelection(r, t) for r, t in views], options=side.options(**core),
    )


PAIR_VIEWS = [(f"img_{i:03d}.png", f"img_{i:03d}.png") for i in range(V)] + [
    ("img_099.png", "img_000.png"),  # missing_reference_image
    ("img_001.png", "img_099.png"),  # missing_target_image
]


def test_stereo_calibrate_serial_and_many_match_jax():
    """``calibrate`` (covariance on) against the JAX facade's, and
    ``calibrate_many`` of the same pair equal to the port's ``calibrate``."""
    payloads = _scene()
    runs = []
    for side in SIDES:
        det, intr = side.detections(payloads), side.intrinsics(["s0", "s1"])
        cfg = _stereo_cfg(side, "p", "s0", "s1", PAIR_VIEWS)
        run = side.facade("StereoCalibrationFacade").calibrate(cfg, det["s0"], det["s1"], intr["s0"], intr["s1"])
        runs.append(run)
        if not side.jax:
            (many,) = side.facade("StereoCalibrationFacade").calibrate_many(
                [(cfg, det["s0"], det["s1"], intr["s0"], intr["s1"])]
            )
            assert_reports_match(_run_json(run), _run_json(many))
    want, got = runs
    assert [v.status for v in got.view_summaries] == ["ok"] * 4 + ["insufficient_points", "ok"] + [
        "missing_reference_image", "missing_target_image",
    ]
    assert got.success and got.used_views == 5
    assert_reports_match(_run_json(want), _run_json(got))
    cov_w, cov_g = np.asarray(want.optimization.core.covariance), got.optimization.core.covariance
    assert np.abs(cov_g - cov_w).max() <= 1e-6 * np.abs(cov_w).max()


def test_multicam_calibrate_many_matches_jax():
    """A 3-camera rig, a 2-camera rig with its own options (a bucket of its
    own) and a rig whose sensor has no intrinsics (its host walk raises:
    that rig's result is the exception, the others solve)."""
    payloads = _scene(seed=4)
    outs = []
    for side in SIDES:
        det, intr = side.detections(payloads), side.intrinsics(["s0", "s1", "s2"])

        def rig(rig_id, sensors, **core):
            return side.fx.MultiCameraRigConfig(
                rig_id=rig_id, sensors=sensors,
                views=[side.fx.MultiCameraViewSelection({s: f"img_{i:03d}.png" for s in sensors}) for i in range(V)],
                options=side.options(**core),
            )

        items = [
            (rig("r3", ["s0", "s1", "s2"], max_iterations=60, compute_covariance=False), det, intr),
            (rig("r2", ["s0", "s2"], max_iterations=50), det, intr),
            (rig("bad", ["s0", "s9"]), det, intr),
        ]
        outs.append([_run_json(r) for r in side.facade("MultiCameraCalibrationFacade").calibrate_many(items)])
    want, got = outs
    assert got[0]["used_views"] == V - 1  # s1's 3-point view drops the whole view
    assert got[0]["success"] and got[1]["success"]
    assert "intrinsics not available for sensor: s9" in got[2]["error"]
    assert_reports_match(want, got)


def test_calibrate_many_lets_a_failing_batched_solve_raise(monkeypatch):
    payloads = _scene()
    side = SIDES[1]
    det, intr = side.detections(payloads), side.intrinsics(["s0", "s1"])
    cfg = _stereo_cfg(side, "p", "s0", "s1", PAIR_VIEWS[:V])

    def broken(jobs, device):
        raise RuntimeError("batched solve failed")

    monkeypatch.setattr(tfleet, "extrinsics_fleet", broken)
    with pytest.raises(RuntimeError, match="batched solve failed"):
        side.facade("StereoCalibrationFacade").calibrate_many([(cfg, det["s0"], det["s1"], intr["s0"], intr["s1"])])


def _stage_context(side, payloads, pairs, intr_sensors):
    ctx = JContext() if side.jax else TContext()
    ctx.dataset = (JDataset if side.jax else TDataset)(planar_cameras=list(side.detections(payloads).values()))
    ctx.intrinsic_results.update(side.intrinsics(intr_sensors))
    if pairs is not None:
        ctx.set_stereo_config(side.fx.StereoCalibrationConfig(pairs=pairs(side)))
    return ctx


def _run_stage(side, ctx):
    stage = JStereoStage() if side.jax else TStereoStage("cpu")
    result = stage.run(ctx)
    return {"success": result.success, "summary": result.summary, "artifacts": ctx.artifacts}


def test_stereo_stage_matches_jax():
    """Every status path in one stage run: an ok pair (with its view-level
    statuses), missing_intrinsics, missing_detections, a pair whose every
    view is insufficient (failed) -> partial_success; the pairs that solve
    share one batched call."""
    payloads = _scene(seed=6)
    payloads.pop("s2")  # s2 has intrinsics but no detections

    def pairs(side):
        return [
            _stereo_cfg(side, "ok", "s0", "s1", PAIR_VIEWS),
            _stereo_cfg(side, "no_intr", "s0", "s9", PAIR_VIEWS[:2]),
            _stereo_cfg(side, "no_det", "s2", "s0", PAIR_VIEWS[:2]),
            _stereo_cfg(side, "all_short", "s1", "s0", [("img_004.png", "img_004.png")]),
            _stereo_cfg(side, "ok_again", "s1", "s0", PAIR_VIEWS[:V]),
        ]

    outs = [_run_stage(side, _stage_context(side, payloads, pairs, ["s0", "s1", "s2"])) for side in SIDES]
    want, got = outs
    statuses = {p["pair_id"]: p["status"] for p in got["summary"]["pairs"]}
    assert statuses == {"ok": "ok", "no_intr": "missing_intrinsics", "no_det": "missing_detections",
                        "all_short": "failed", "ok_again": "ok"}
    assert got["summary"]["status"] == "partial_success" and not got["success"]
    assert_reports_match(want, got)


@pytest.mark.parametrize("case", ["no_config", "one_camera", "no_pairs"])
def test_stereo_stage_early_statuses_match_jax(case):
    payloads = _scene()
    outs = []
    for side in SIDES:
        pairs = None if case == "no_config" else (lambda s: [])
        ctx = _stage_context(side, payloads, pairs, ["s0"] if case == "one_camera" else ["s0", "s1"])
        outs.append(_run_stage(side, ctx))
    want, got = outs
    assert got["summary"]["status"] == {
        "no_config": "missing_config", "one_camera": "waiting_for_multiple_intrinsic_results",
        "no_pairs": "no_pairs_configured",
    }[case]
    assert_reports_match(want, got)


# ------------------------------------------------------------------- the app


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    assert japp.main(["--input", INPUT, "--output", str(tmp / "jax.json")]) == 0
    assert tapp.main(["--input", INPUT, "--output", str(tmp / "port.json"), "--device", "cpu"]) == 0
    return tuple(json.loads((tmp / f"{who}.json").read_text()) for who in ("jax", "port"))


def test_app_artifacts_match_jax(artifacts):
    """The stage wall times (``duration_s``) are the only keys not held."""
    want, got = (chip_smoke.without_durations(a) for a in artifacts)
    assert [s["name"] for s in got["pipeline_summary"]["stages"]] == ["intrinsics", "stereo"]
    assert_reports_match(want, got)


def test_app_artifacts_recover_the_truth(artifacts):
    """The verify recipe's checks on the port's artifacts."""
    got = artifacts[1]
    assert got["pipeline_summary"]["success"]
    c1 = np.array(got["stereo"]["pairs"]["pair0"]["optimization"]["c_se3_r"][1])
    assert np.allclose(c1[:3, 3], CAM1_T, atol=5e-3)
    m1 = np.array(got["multicam"]["rig0"]["optimization"]["c_se3_r"][1])
    assert np.allclose(m1[:3, 3], CAM1_T, atol=5e-3)
    assert got["multicam"]["rig0"]["success"]


def test_app_refuses_a_missing_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tapp.main(["--input", INPUT, "--output", "unused.json", "--device", "cuda"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("Calibration pipeline failed: ") and "cuda" in err[-1]
