"""Port equivalence of the homography slice, CPU, float64: the refine
(``optimize_homography``, covariance on), ``homography_batch`` in one phase
and phased with the float64 seed, ``estimate_homography`` by DLT and by
RANSAC fed JAX's draws, and the homography app's JSON, each against its
JAX counterpart on the same inputs; and the app's refusal of a missing
card.

Data: the JAX package's config-1 generator (benchmarks/problems.py::
homography_problems, restated without JAX in chip_smoke.py) at a few
lanes.

Bars: iterations, linearizations and termination exactly equal per lane,
cost 1e-10 relative, H 1e-8 relative; the covariance 1e-8 relative to its
largest entry; the seed 1e-9; RANSAC inlier masks exactly equal; the app's
JSON equal up to floats (H 1e-8, rms 1e-9, cost 1e-10 relative) and its LM
report text equal up to its printed numbers.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as pb
from calibration_tpu.apps import homography as japp
from calibration_tpu.ops import homography as jH
from calibration_tpu.ops import ransac as jr
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.optim import optimize_homography as j_optimize_homography
from calibration_tpu.parallel import batched as jbatched
from calibration_tpu_torch import convert
from calibration_tpu_torch.apps import homography as tapp
from calibration_tpu_torch.ops import homography as tH
from calibration_tpu_torch.ops import ransac as tr
from calibration_tpu_torch.optim import homography as tho
from calibration_tpu_torch.parallel import batched as tbatched
from torch_helpers import _report_numbers, one_torch_thread, t64  # noqa: F401

INPUT = "examples/data/homography_input.json"


def _assert_lm_equal(t_lm, j_lm):
    for name in ("iterations", "linearizations", "termination", "success"):
        np.testing.assert_array_equal(getattr(t_lm, name).numpy(), np.asarray(getattr(j_lm, name)), err_msg=name)
    np.testing.assert_allclose(t_lm.cost.numpy(), j_lm.cost, rtol=1e-10)


def test_optimize_homography_matches_jax():
    """One problem from a perturbed seed, covariance on (ssr / (m - 8))."""
    _, src, dst = pb.homography_problems(1, seed=5)
    h0 = np.array(jH.estimate_homography_dlt(jnp.asarray(src[0]), jnp.asarray(dst[0])))
    h0[:2, 2] += [0.3, -0.2]
    jopts = JOptimOptions(max_iterations=50)
    want = j_optimize_homography(src[0], dst[0], h0, jopts)
    got = tho.optimize_homography(t64(src[0]), t64(dst[0]), t64(h0), convert.optim_options(jopts))
    assert got.core.success and got.core.report == want.core.report
    assert (got.core.iterations, got.core.termination) == (want.core.iterations, want.core.termination)
    np.testing.assert_allclose(got.core.final_cost, want.core.final_cost, rtol=1e-10)
    np.testing.assert_allclose(got.homography, want.homography, rtol=1e-8, atol=1e-12)
    cov_w = np.asarray(want.core.covariance)
    assert np.abs(got.core.covariance - cov_w).max() <= 1e-8 * np.abs(cov_w).max()
    with pytest.raises(ValueError, match="At least 4"):
        tho.optimize_homography(t64(src[0, :3]), t64(dst[0, :3]), t64(h0))


@pytest.mark.parametrize("two_phase", [False, True], ids=["one_phase", "phased"])
def test_homography_batch_matches_jax(two_phase, monkeypatch):
    """8 lanes with a masked tail on one, covariance on; phased with the
    phase boundary at JAX's cap."""
    monkeypatch.setattr(tbatched, "HOMOG_PHASE_CAP", jbatched.HOMOG_PHASE_CAP)
    _, src, dst = pb.homography_problems(8, seed=7)
    mask = np.ones(src.shape[:2])
    mask[2, -5:] = 0.0
    jopts = JOptimOptions(max_iterations=50, huber_delta=0.05)
    want = jax.device_get(jbatched.homography_batch(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), options=jopts, two_phase=two_phase, seed_precision="f64"
    ))
    got = tbatched.homography_batch(
        t64(src), t64(dst), t64(mask), options=convert.optim_options(jopts), two_phase=two_phase
    )
    _assert_lm_equal(got[0], want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-8, atol=1e-12)
    assert bool(got[3].all()) and bool(np.all(want[3]))
    scale = np.abs(want[2]).max(axis=(-2, -1))
    assert np.all(np.abs(got[2].numpy() - want[2]).max(axis=(-2, -1)) <= 1e-8 * scale)
    if two_phase:
        assert int(got[0].iterations.max()) > tbatched.HOMOG_PHASE_CAP  # the second phase ran


def test_homography_batch_f32_seed_reaches_the_same_minimum():
    """The opt-in float32 seed: the float64 LM lands on the f64 seed's
    minimum (cost 1e-9 relative)."""
    _, src, dst = pb.homography_problems(6, seed=9)
    opts = convert.optim_options(JOptimOptions(max_iterations=50, compute_covariance=False))
    f64 = tbatched.homography_batch(t64(src), t64(dst), options=opts)
    f32 = tbatched.homography_batch(t64(src), t64(dst), options=opts, seed_precision="f32")
    assert bool(f32[0].success.all())
    np.testing.assert_allclose(f32[0].cost.numpy(), f64[0].cost.numpy(), rtol=1e-9)
    with pytest.raises(ValueError, match="seed_precision"):
        tbatched.homography_batch(t64(src), t64(dst), options=opts, seed_precision="f16")


def jax_draws(seed, r, shape, device):
    """The Gumbel noise JAX's ransac draws in round r."""
    g = jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), r), shape)
    return torch.tensor(np.asarray(g), dtype=torch.float64, device=device)


def _outlier_problem():
    _, src, dst = pb.homography_problems(1, n=40, noise=0.002, seed=13)
    dst = dst[0].copy()
    dst[:6] += np.random.default_rng(2).uniform(20, 40, (6, 2))
    return src[0], dst


@pytest.mark.parametrize("ransac", [False, True], ids=["dlt", "ransac"])
def test_estimate_homography_matches_jax(ransac, monkeypatch):
    src, dst = _outlier_problem()
    if not ransac:
        src, dst = src[6:], dst[6:]
    opts = dict(max_iters=500, thresh=1.0, min_inliers=12)
    monkeypatch.setattr(tr, "round_noise", jax_draws)
    want = jH.estimate_homography(jnp.asarray(src), jnp.asarray(dst), ransac_options=jr.RansacOptions(**opts) if ransac else None)
    got = tH.estimate_homography(t64(src), t64(dst), ransac_options=tr.RansacOptions(**opts) if ransac else None)
    assert bool(got["success"]) and bool(want["success"])
    np.testing.assert_array_equal(got["inlier_mask"].numpy(), np.asarray(want["inlier_mask"]))
    np.testing.assert_allclose(got["hmtx"].numpy(), want["hmtx"], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(got["symmetric_rms_px"]), float(want["symmetric_rms_px"]), rtol=1e-9)
    if ransac:
        assert not got["inlier_mask"][:6].any() and got["inlier_mask"][6:].all()
    # a batch of lanes gives each lane's single-problem result
    many = tH.estimate_homography(t64(np.stack([src, src])), t64(np.stack([dst, dst])))
    assert many["hmtx"].shape == (2, 3, 3) and bool(many["success"].all())


def _assert_app_json_equal(want, got, path=""):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            _assert_app_json_equal(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_app_json_equal(w, g, f"{path}[{i}]")
    elif isinstance(want, float):
        rtol = 1e-10 if path.endswith("final_cost") else 1e-8
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12, err_msg=path)
    elif path.endswith("/report"):
        (wn, wt), (gn, gt) = _report_numbers(want), _report_numbers(got)
        assert wt == gt, path
        np.testing.assert_allclose(gn, wn, rtol=1e-6, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("ransac", [False, True], ids=["dlt", "ransac"])
def test_app_matches_jax(ransac, tmp_path, monkeypatch):
    """The committed example input, and the same with a RANSAC section and
    planted outliers (the port fed JAX's draws)."""
    path = INPUT
    if ransac:
        src, dst = _outlier_problem()
        payload = {
            "correspondences": [{"object_xy": s.tolist(), "image_uv": d.tolist()} for s, d in zip(src, dst)],
            "ransac": {"thresh": 1.0, "max_iters": 500}, "optimize": True,
            "options": {"huber_delta": 1.0, "max_iterations": 100},
        }
        path = tmp_path / "in.json"
        path.write_text(json.dumps(payload))
    monkeypatch.setattr(tr, "round_noise", jax_draws)
    assert japp.main(["--input", str(path), "-o", str(tmp_path / "jax.json")]) == 0
    assert tapp.main(["--input", str(path), "-o", str(tmp_path / "port.json"), "--device", "cpu"]) == 0
    want, got = (json.loads((tmp_path / f"{who}.json").read_text()) for who in ("jax", "port"))
    assert "covariance" in got["optimized"]["core"]
    _assert_app_json_equal(want, got)


def test_app_refuses_a_missing_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tapp.main(["--input", INPUT, "--device", "cuda"]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("Homography failed: ") and "cuda" in err[-1]
