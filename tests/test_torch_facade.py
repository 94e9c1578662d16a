"""Port equivalence of the planar-intrinsics facade
(``calibration_tpu_torch/pipeline/facades/intrinsics.py``): ``calibrate``
and ``calibrate_many`` against the JAX package's on the same detections and
configs, CPU, float64; and the repaired ``IntrinsicsOptimOptions``.

Sensors: three with planted outliers in two view-count buckets (6, 5 and 8
views of a 6x8 grid, 0.2 px noise, 6 points per view moved by 30-80 px) and
one with too few views. Configs: the RANSAC prefilter, then the LM refine
or the linear estimate alone (``refine: false``). Without the prefilter the
two packages' linear K differ on such views: the reference's two-step
inverse-power DLT null vector has not converged when the smallest singular
values are close (ratio ~0.4 with 6 gross outliers: 1e-3 relative error
against an SVD, where the port's ``eigh`` is exact to 1e-15).

Bars: the linear K within 1e-9 relative; the refined camera within 1e-6
relative; view errors within 1e-8 px; the final cost within 1e-7 relative;
inlier masks and counts, warnings, active views and LM counters exactly
equal; a failed sensor carries the same message.
"""

import dataclasses
import json

import numpy as np
import pytest

import synth
from calibration_tpu.io import jsonio as jjsonio
from calibration_tpu.optim import IntrinsicsOptimOptions as JIntrOptions
from calibration_tpu.pipeline.dataset import PlanarDetections as JDetections
from calibration_tpu.pipeline.facades import intrinsics as jf
from calibration_tpu_torch.io import jsonio as tjsonio
from calibration_tpu_torch.optim import IntrinsicsOptimOptions as TIntrOptions
from calibration_tpu_torch.pipeline.dataset import PlanarDetections as TDetections
from calibration_tpu_torch.pipeline.facades import intrinsics as tf
from chip_smoke import detections_payload
from torch_helpers import one_torch_thread  # noqa: F401

SENSORS = {"s0": 6, "s1": 8, "s2": 5, "s3": 3}  # views; s3 has too few


def _payloads():
    rng = np.random.default_rng(23)
    intr = synth.default_camera()
    obj = synth.make_target_grid(6, 8, 0.04)
    out = {}
    for i, (sid, views) in enumerate(SENSORS.items()):
        poses = synth.circle_views(views, tilt=0.25 + 0.02 * i)
        uv = synth.render_pixels(intr, poses, obj, noise=0.2, rng=rng)
        for v in range(views):
            bad = rng.choice(obj.shape[0], 6, replace=False)
            uv[v, bad] += rng.uniform(30, 80, (6, 2)) * rng.choice([-1, 1], (6, 2))
        out[sid] = detections_payload(sid, obj, uv)
    return out


def _config(refine: bool):
    return {
        "algorithm": "planar",
        "options": {
            "optim_options": {"core": {"max_iterations": 40, "compute_covariance": False}},
            "estim_options": {"homography_ransac": {"max_iters": 500}},
            "min_corners_per_view": 20,
            "refine": refine,
        },
        "cameras": [{"camera_id": sid, "image_size": [640, 480]} for sid in SENSORS],
    }


def _run(pkg_facade, jsonio, det_cls, cfg_json, payloads, facade):
    cfg = jsonio.from_jsonable(cfg_json, pkg_facade.IntrinsicCalibrationConfig)
    jobs = [(cam, jsonio.from_jsonable(payloads[cam.camera_id], det_cls)) for cam in cfg.cameras]
    many = facade.calibrate_many(cfg, jobs)
    serial = [facade.calibrate(cfg, *jobs[i]) for i in (0, 1)] if cfg.options.refine else []
    return many, serial


@pytest.fixture(scope="module")
def runs():
    payloads = _payloads()
    out = {}
    for refine in (True, False):
        cfg = _config(refine)
        out[refine] = (
            _run(jf, jjsonio, JDetections, cfg, payloads, jf.PlanarIntrinsicCalibrationFacade()),
            _run(tf, tjsonio, TDetections, cfg, payloads, tf.PlanarIntrinsicCalibrationFacade("cpu")),
        )
    return out


def _assert_outputs_match(t, j):
    np.testing.assert_allclose(t.linear_kmtx, np.asarray(j.linear_kmtx), rtol=1e-9)
    np.testing.assert_allclose(t.view_homographies, np.asarray(j.view_homographies), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(t.view_h_rms, np.asarray(j.view_h_rms), rtol=1e-9)
    np.testing.assert_array_equal(t.view_inlier_masks, j.view_inlier_masks)
    for name in (
        "linear_view_indices", "view_h_ok", "view_inlier_counts", "total_input_views",
        "accepted_views", "used_views", "total_points_used", "min_corner_threshold",
        "invalid_k_warnings", "pose_warnings", "rms_check_warnings",
    ):
        assert getattr(t, name) == getattr(j, name), name
    assert [dataclasses.astuple(a) for a in t.active_views] == [dataclasses.astuple(a) for a in j.active_views]
    tr, jr = t.refine_result, j.refine_result
    np.testing.assert_allclose(tr.camera, np.asarray(jr.camera), rtol=1e-6)
    np.testing.assert_allclose(tr.view_errors, np.asarray(jr.view_errors), rtol=0, atol=1e-8)
    assert tr.c_se3_t.shape == np.asarray(jr.c_se3_t).shape
    assert (tr.core.success, tr.core.iterations, tr.core.termination) == (
        jr.core.success, jr.core.iterations, int(jr.core.termination),
    )
    np.testing.assert_allclose(tr.core.final_cost, jr.core.final_cost, rtol=1e-7)


@pytest.mark.parametrize("refine", [True, False], ids=["ransac-refine", "linear-only"])
def test_calibrate_many_matches_jax(runs, refine):
    (j_many, _), (t_many, _) = runs[refine]
    for sid, j, t in zip(SENSORS, j_many, t_many):
        if sid == "s3":
            assert isinstance(j, RuntimeError) and isinstance(t, RuntimeError)
            assert str(t) == str(j) and "at least 4 views" in str(t)
            continue
        _assert_outputs_match(t, j)
        # the prefilter removed exactly the planted outliers
        assert t.view_inlier_counts == [42] * SENSORS[sid]
        if refine:
            np.testing.assert_allclose(t.view_rms_check, j.view_rms_check, rtol=2e-3)


def test_calibrate_matches_jax(runs):
    (_, j_serial), (_, t_serial) = runs[True]
    for t, j in zip(t_serial, j_serial):
        _assert_outputs_match(t, j)


def test_other_models_fail_per_sensor(runs):
    """A model name the registry does not know fails that sensor alone,
    with the reference's message, and never runs another path. (Pinhole and
    Scheimpflug are the registry's models: tests/test_torch_scheimpflug.py
    holds the Scheimpflug facade to JAX's.)"""
    payloads = _payloads()
    cfg = tjsonio.from_jsonable(_config(True), tf.IntrinsicCalibrationConfig)
    cfg.cameras = cfg.cameras[:2]
    cfg.cameras[1].model = "fisheye"
    facade = tf.PlanarIntrinsicCalibrationFacade("cpu")
    jobs = [(cam, tjsonio.from_jsonable(payloads[cam.camera_id], TDetections)) for cam in cfg.cameras]
    ok, bad = facade.calibrate_many(cfg, jobs)
    assert isinstance(bad, KeyError) and "Unknown camera model 'fisheye'" in str(bad)
    (_, _), (t_many, _) = runs[True]
    # s0 solves alone here and beside s2 there: the same lane up to rounding
    np.testing.assert_allclose(ok.refine_result.camera, t_many[0].refine_result.camera, rtol=1e-9)
    with pytest.raises(KeyError, match="Unknown camera model"):
        facade.calibrate(cfg, *jobs[1])


def test_options_match_jax_field_for_field():
    """The port's IntrinsicsOptimOptions has the JAX field list in order,
    so the report's positional field_N keys agree."""
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]
    assert names(TIntrOptions) == names(JIntrOptions)
    raw = json.loads(open("examples/data/planar_intrinsics_config.json").read())
    raw["options"]["optim_options"]["mixed_coarse_epsilon"] = 1e-3
    j = jjsonio.from_jsonable(raw, jf.IntrinsicCalibrationConfig)
    t = tjsonio.from_jsonable(raw, tf.IntrinsicCalibrationConfig)
    assert tjsonio.to_jsonable(t.options) == jjsonio.to_jsonable(j.options)
    assert t.options.optim_options.mixed_coarse_epsilon == 1e-3


def test_fleet_covariance_stays_on_device_until_read():
    """calibrate_many leaves the ambient covariance batch on the device
    (utils/lazy.py): one fetch on first read serves every sensor of the
    group, and it equals the serial solve's covariance."""
    from calibration_tpu_torch.pipeline.loaders import read_detections
    from calibration_tpu_torch.utils.lazy import LazyDeviceArray

    cfg = tf.load_calibration_config("examples/data/planar_intrinsics_config.json")
    jobs = [(cam, read_detections(f"examples/data/detections_{cam.camera_id}.json")) for cam in cfg.cameras]
    facade = tf.PlanarIntrinsicCalibrationFacade("cpu")
    a, b = facade.calibrate_many(cfg, jobs)
    cov_a, cov_b = a.refine_result.core.covariance, b.refine_result.core.covariance
    assert isinstance(cov_a, LazyDeviceArray) and repr(cov_b).startswith("LazyDeviceArray(pending")
    dense = np.asarray(cov_a)
    assert repr(cov_b).startswith("LazyDeviceArray(materialized")  # one fetch for the group
    n_amb = 10 + 7 * 12  # pinhole + 7 per view, 10 views bucketed to 12
    assert dense.shape == (n_amb, n_amb) and np.isfinite(dense).all()
    serial = facade.calibrate(cfg, *jobs[0]).refine_result.core.covariance
    assert np.linalg.norm(dense - serial) <= 1e-6 * np.linalg.norm(serial)
