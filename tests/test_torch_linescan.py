"""Port equivalence of the line-scan slice (``calibration_tpu_torch/ops/
{planefit, linescan}.py``, ``ops/ransac.ransac_plane``,
``parallel/batched.linescan_batch`` / ``linescan_ransac_batch``, the
line-scan facade and the ``linescan_calibration`` app) against the JAX
package, CPU, float64.

Data: ``chip_smoke.linescan_problems`` (the JAX package's row-5 generator
restated, held equal to it by tests/test_torch_smoke.py) at 4 rigs x 3
views, pinhole and Scheimpflug (tau = (0.06, -0.04)), with 20% junk laser
pixels for the RANSAC paths, as bench_all.py's rows 5R and 5S.

Bars: plane fits and plane homographies within 1e-12, the plane's sign
included (the port adopts the reference's rule: the sign its inverse-power
null vector takes, a well-separated smallest singular value assumed); the
batch functions' planes, homographies and RMS within 1e-9 with inlier counts
and ``ok`` equal, RANSAC fed JAX's own draws; the facade's statuses equal;
the app's artifact within ``torch_helpers.report_tolerance``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from calibration_tpu.apps import linescan_calibration as japp
from calibration_tpu.ops import linescan as jls
from calibration_tpu.ops import planefit as jpf
from calibration_tpu.ops import ransac as jr
from calibration_tpu.parallel import batched as jbatched
from calibration_tpu.pipeline.facades import linescan as jfac
from calibration_tpu_torch.apps import linescan_calibration as tapp
from calibration_tpu_torch.ops import linescan as tls
from calibration_tpu_torch.ops import planefit as tpf
from calibration_tpu_torch.ops import ransac as tr
from calibration_tpu_torch.parallel import batched as tbatched
from calibration_tpu_torch.pipeline.facades import linescan as tfac
from torch_helpers import assert_reports_match, one_torch_thread, t64  # noqa: F401

B, V = 4, 3
SCHEIM = chip_smoke.SCHEIM_NAME
RANSAC = dict(chip_smoke.LINESCAN_RANSAC_OPTS)
INPUT = "examples/data/linescan_input.json"


def jax_draws(seed, r, shape, device):
    """The Gumbel noise JAX's ransac draws in round r (one key for every
    vmapped lane, folded with the round), in ``round_noise``'s place."""
    g = jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), r), shape)
    return torch.tensor(np.asarray(g), dtype=torch.float64, device=device)


def _plane_points(b=B, n=50, seed=1):
    """Noisy points of B planes: (pts (B, N, 3), mask (B, N))."""
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(b, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    e1 = np.cross(normals, [0.3, 0.5, 0.8])
    e1 /= np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = np.cross(normals, e1)
    uv = rng.uniform(-0.2, 0.2, (b, n, 2))
    pts = 0.9 * normals[:, None] + uv[..., :1] * e1[:, None] + uv[..., 1:] * e2[:, None]
    pts += rng.normal(0, 1e-4, pts.shape)
    mask = rng.uniform(size=(b, n)) > 0.15
    return pts, mask


def test_fit_plane_svd_matches_jax_sign_included():
    pts, mask = _plane_points()
    for m in (None, mask):
        want = np.asarray(jpf.fit_plane_svd(jnp.asarray(pts), None if m is None else jnp.asarray(m)))
        got = tpf.fit_plane_svd(t64(pts), None if m is None else torch.tensor(m)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the sign is the reference's for either orientation of the data
    flipped = tpf.fit_plane_svd(t64(-pts)).numpy()
    np.testing.assert_allclose(flipped, np.asarray(jpf.fit_plane_svd(jnp.asarray(-pts))), rtol=0, atol=1e-12)


def test_fit_plane_3pt_distance_and_rms_match_jax():
    pts, mask = _plane_points()
    p = pts[:, :3]
    p_degen = p.copy()
    p_degen[1, 2] = 0.5 * (p_degen[1, 0] + p_degen[1, 1])  # collinear: not ok
    want, want_ok = jpf.fit_plane_3pt(*(jnp.asarray(p_degen[:, i]) for i in range(3)))
    got, got_ok = tpf.fit_plane_3pt(*(t64(p_degen[:, i]) for i in range(3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert not bool(got_ok[1]) and bool(got_ok[0])
    plane = np.asarray(jpf.fit_plane_svd(jnp.asarray(pts)))
    np.testing.assert_allclose(tpf.plane_point_distance(t64(plane), t64(pts)).numpy(),
                               np.asarray(jpf.plane_point_distance(jnp.asarray(plane), jnp.asarray(pts))), atol=1e-15)
    np.testing.assert_allclose(tpf.plane_rms(t64(plane), t64(pts), torch.tensor(mask)).numpy(),
                               np.asarray(jpf.plane_rms(jnp.asarray(plane), jnp.asarray(pts), jnp.asarray(mask))),
                               rtol=1e-12)


def test_build_plane_homography_matches_jax():
    pts, _ = _plane_points()
    planes = np.array(jpf.fit_plane_svd(jnp.asarray(pts)))
    planes[0] = [0.05, 0.1, 0.99373, -0.4]  # a normal near z: the other basis branch
    got = tls.build_plane_homography(t64(planes)).numpy()
    want = np.stack([np.asarray(jls.build_plane_homography(jnp.asarray(p))) for p in planes])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def _unprojected(model, camera, obj, tgt_uv, laser_uv):
    """The rigs' normalized coordinates, through the JAX model."""
    from calibration_tpu.models.registry import get_model

    spec = get_model(model)
    cam = jnp.asarray(camera)[:, None, None]
    return np.asarray(spec.unproject_normalized(cam, jnp.asarray(tgt_uv))), \
        np.asarray(spec.unproject_normalized(cam, jnp.asarray(laser_uv)))


@pytest.mark.parametrize("model", ["pinhole", "scheimpflug"])
def test_calibrate_laser_plane_matches_jax(model):
    tilt = chip_smoke.LINESCAN_TILT if model == "scheimpflug" else None
    camera, obj, tgt_uv, laser_uv, _ = chip_smoke.linescan_problems(B, views=V, tilt_tau=tilt)
    tgt_n, laser_n = _unprojected(model, camera, obj, tgt_uv, laser_uv)
    lmask = np.ones(laser_uv.shape[:-1], bool)
    lmask[1, 2, ::3] = False
    jres, jpts, jmask = jax.jit(jax.vmap(lambda o, t, l, m: jls.calibrate_laser_plane(o, t, l, laser_mask=m)))(
        jnp.asarray(obj), jnp.asarray(tgt_n), jnp.asarray(laser_n), jnp.asarray(lmask))
    tres, tpts, tmask = tls.calibrate_laser_plane(t64(obj), t64(tgt_n), t64(laser_n), laser_mask=torch.tensor(lmask))
    np.testing.assert_allclose(tpts.numpy(), np.asarray(jpts), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for name in ("plane", "homography", "rms_error", "covariance"):
        np.testing.assert_allclose(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    for name in ("inlier_count", "ok"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(), np.asarray(getattr(jres, name)), err_msg=name)


def _rows(model, outliers):
    tilt = chip_smoke.LINESCAN_TILT if model == SCHEIM else None
    seed = 37 if tilt else 31
    camera, obj, tgt_uv, laser_uv, truth = chip_smoke.linescan_problems(B, views=V, seed=seed, tilt_tau=tilt)
    if outliers:
        laser_uv = chip_smoke.with_laser_outliers(laser_uv, seed)
    return (camera, obj, tgt_uv, laser_uv), truth


@pytest.mark.parametrize("model", [chip_smoke.PINHOLE_NAME, SCHEIM])
@pytest.mark.parametrize("ransac", [False, True], ids=["svd", "ransac"])
def test_linescan_batches_match_jax(model, ransac, monkeypatch):
    args, truth = _rows(model, ransac)
    tmask = np.ones(args[1].shape[:-1], bool)
    tmask[2, 1, -4:] = False  # a ragged target view
    if ransac:
        monkeypatch.setattr(tr, "round_noise", jax_draws)
        want = jbatched.linescan_ransac_batch(*args, target_mask=tmask, options=jr.RansacOptions(**RANSAC),
                                              model_name=model)
        got = tbatched.linescan_ransac_batch(*(t64(a) for a in args), target_mask=torch.tensor(tmask),
                                             options=tr.RansacOptions(**RANSAC), model_name=model)
    else:
        want = jbatched.linescan_batch(*args, target_mask=tmask, model_name=model)
        got = tbatched.linescan_batch(*(t64(a) for a in args), target_mask=torch.tensor(tmask), model_name=model)
    want = jax.device_get(want)
    for name in ("plane", "homography", "rms_error", "covariance"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-9,
                                   atol=1e-12, err_msg=name)
    for name in ("inlier_count", "ok"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert bool(got.ok.all())
    angle = np.degrees(np.arccos(np.clip(np.abs(np.sum(got.plane[:, :3].numpy() * truth[:, :3], -1)), 0, 1)))
    assert angle.max() < 2.0
    if ransac:  # the junk pixels are out: fewer inliers than lifted points
        assert int(got.inlier_count.max()) < V * args[3].shape[2]


def test_ransac_plane_matches_jax(monkeypatch):
    """ransac_plane with a masked datum tail, lane for lane on JAX's draws."""
    pts, mask = _plane_points(n=60)
    pts[:, ::5] += np.random.default_rng(2).uniform(-0.3, 0.3, pts[:, ::5].shape)  # gross outliers
    opts = dict(max_iters=300, thresh=0.005, min_inliers=12)
    want = jax.device_get(jax.jit(jax.vmap(lambda p, m: jr.ransac_plane(p, jr.RansacOptions(**opts), mask=m)))(
        jnp.asarray(pts), jnp.asarray(mask)))
    monkeypatch.setattr(tr, "round_noise", jax_draws)
    got = tr.ransac_plane(t64(pts), tr.RansacOptions(**opts), mask=torch.tensor(mask))
    for name in ("success", "inlier_mask", "inlier_count", "iters"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.model.numpy(), np.asarray(want.model), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.inlier_rms.numpy(), np.asarray(want.inlier_rms), rtol=1e-10)


def _views(model, outliers=False):
    (camera, obj, tgt_uv, laser_uv), _ = _rows(model, outliers)
    return camera[0], [(obj[0, v], tgt_uv[0, v], laser_uv[0, v]) for v in range(V)]


FACADE_CASES = {
    # case: (model, plane fit)
    "svd_pinhole": (chip_smoke.PINHOLE_NAME, "svd"),
    "svd_scheimpflug": (SCHEIM, "svd"),
    "ransac_scheimpflug": (SCHEIM, "ransac"),
}


def _facade_options(fac, fit):
    opts = fac.LinescanCalibrationOptions()
    if fit != "svd":
        opts.plane_fit.use_ransac = True
        extra = dict(min_inliers=10**6) if fit == "ransac_strict" else {}
        opts.plane_fit.ransac_options = fac.RansacConfig(**dict(RANSAC, **extra))
    return opts


@pytest.mark.parametrize("case", sorted(FACADE_CASES))
def test_facade_matches_jax(case, monkeypatch):
    model, fit = FACADE_CASES[case]
    camera, views = _views(model, outliers=fit != "svd")
    monkeypatch.setattr(tr, "round_noise", jax_draws)
    want, got = (
        facade.calibrate(camera, [fac.LineScanViewData(*v) for v in views], _facade_options(fac, fit), model=model)
        for fac, facade in ((jfac, jfac.LinescanCalibrationFacade()), (tfac, tfac.LinescanCalibrationFacade("cpu")))
    )
    assert want.success and got.success and got.used_views == want.used_views == V
    np.testing.assert_allclose(got.result.plane, np.asarray(want.result.plane), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.result.homography, np.asarray(want.result.homography), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.result.rms_error, want.result.rms_error, rtol=1e-9)
    assert (got.result.summary, got.result.inlier_count) == (want.result.summary, want.result.inlier_count)


FAILURES = {
    # the reference's failure statuses (its tests assert success False on
    # each): case -> (model, camera length cut, views edit, plane fit)
    "too_few_views": (chip_smoke.PINHOLE_NAME, None, lambda vs: vs[:1], "svd"),
    "too_few_target_points": (chip_smoke.PINHOLE_NAME, None,
                              lambda vs: [vs[0], (vs[1][0][:3], vs[1][1][:3], vs[1][2])], "svd"),
    "wrong_camera_length": (SCHEIM, 10, None, "svd"),
    "too_few_laser_points": (chip_smoke.PINHOLE_NAME, None, lambda vs: [(o, u, l[:1]) for o, u, l in vs[:2]], "svd"),
    "ransac_fails": (chip_smoke.PINHOLE_NAME, None, None, "ransac_strict"),
}


@pytest.mark.parametrize("case", sorted(FAILURES))
def test_facade_failure_statuses(case):
    model, cut, edit, fit = FAILURES[case]
    camera, views = _views(model, outliers=fit != "svd")
    camera = camera[:cut] if cut else camera
    views = edit(views) if edit else views
    run = tfac.LinescanCalibrationFacade("cpu").calibrate(
        camera, [tfac.LineScanViewData(*v) for v in views], _facade_options(tfac, fit), model=model
    )
    assert not run.success and run.used_views == len(views)
    assert (run.result.summary, run.result.inlier_count) == ("", 0)  # no partial result


def test_facade_lets_other_failures_propagate():
    """The reference turns any exception into success = False; the port
    only its own validation failures. A view whose pixel count is not its
    target count is a caller's error, and it raises."""
    camera, views = _views(chip_smoke.PINHOLE_NAME)
    views[1] = (views[1][0], views[1][1][:-2], views[1][2])
    assert not jfac.LinescanCalibrationFacade().calibrate(camera, [jfac.LineScanViewData(*v) for v in views]).success
    with pytest.raises(ValueError):
        tfac.LinescanCalibrationFacade("cpu").calibrate(camera, [tfac.LineScanViewData(*v) for v in views])


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("linescan")
    paths = chip_smoke.linescan_app_inputs(tmp, views=V)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tr, "round_noise", jax_draws)
        for name, path in paths.items():
            codes = (japp.main(["--input", str(path), "--output", str(tmp / f"{name}_jax.json")]),
                     tapp.main(["--input", str(path), "--output", str(tmp / f"{name}_port.json"), "--device", "cpu"]))
            out[name] = codes, tuple(json.loads((tmp / f"{name}_{w}.json").read_text()) for w in ("jax", "port"))
    return out


@pytest.mark.parametrize("name", ["example", "ransac", "scheimpflug"])
def test_app_artifact_matches_jax(app_runs, name):
    codes, (want, got) = app_runs[name]
    assert codes == (0, 0)
    assert_reports_match(want, got)
    assert got["success"] and got["plane"]["method"] == ("ransac" if name == "ransac" else "linear_svd")


def test_app_errors_exit_1(tmp_path, capsys, monkeypatch):
    """Malformed laser_uv exits 1 with the app's line, as the JAX app does;
    so does --device cuda without a card (never a run on the CPU)."""
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({
        "camera": {"kmtx": {"fx": 600, "fy": 600, "cx": 320, "cy": 240}},
        "views": [{"target_view": [{"object_xy": [x, y], "image_uv": [10 + 10 * x, 10 + 10 * y]}
                                   for x in (0, 1) for y in (0, 1)], "laser_uv": [1.0, 2.0, 3.0]}],
    }))
    assert tapp.main(["--input", str(bad), "--output", str(tmp_path / "o.json"), "--device", "cpu"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1] == "Linescan calibration failed: laser_uv entry must be [u,v]"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tapp.main(["--input", INPUT, "--output", str(tmp_path / "o.json"), "--device", "cuda"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("Linescan calibration failed: ") and "cuda" in err[-1]
