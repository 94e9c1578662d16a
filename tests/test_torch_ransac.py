"""Port equivalence of the batched RANSAC homography prefilter
(``calibration_tpu_torch/ops/ransac.py``) against the JAX package's
``jax.vmap(ransac_homography)``, CPU, float64.

The data is the outlier setup of the JAX facade's prefilter test (pure
pinhole, 6x8 grid, 0.2 px noise, gross outliers of 30-80 px), with one
clean view that stops after round 0, one view with ~60% outliers that runs
more rounds, and one view with a masked tail.

Bars: fed JAX's own Gumbel draws (``round_noise`` substituted), success,
inlier masks, counts and hypotheses evaluated are exactly equal lane for
lane, the model and inlier RMS within 1e-9 relative (null vectors come from
another factorization, an SVD here and inverse power iteration there). With
the port's own generator the masks still equal JAX's and the planted truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth
from calibration_tpu.ops import homography as jh
from calibration_tpu.ops import ransac as jr
from calibration_tpu_torch.ops import homography as th
from calibration_tpu_torch.ops import ransac as tr
from torch_helpers import one_torch_thread, ransac_rounds, t64  # noqa: F401

OPTS = dict(max_iters=1000, thresh=2.0, min_inliers=12)
CLEAN, HEAVY, RAGGED = 4, 5, 1  # lanes: no outliers, ~60% outliers, masked tail


def outlier_views():
    rng = np.random.default_rng(17)
    intr = synth.default_camera()
    intr[5:] = 0.0  # pure pinhole: the homography is exact for inliers
    obj = synth.make_target_grid(6, 8, 0.04)
    v, n = 6, obj.shape[0]
    uv = synth.render_pixels(intr, synth.circle_views(v), obj, noise=0.2, rng=rng)
    planted = np.zeros((v, n), bool)
    for i in range(v):
        k = {CLEAN: 0, HEAVY: 29}.get(i, 6)
        bad = rng.choice(n, k, replace=False)
        uv[i, bad] += rng.uniform(30, 80, (k, 2))
        planted[i, bad] = True
    mask = np.ones((v, n), bool)
    mask[RAGGED, -5:] = False
    return np.tile(obj[None], (v, 1, 1)), uv, mask, planted


def jax_draws(seed, r, shape, device):
    """The Gumbel noise JAX's ransac draws in round r: one key for every
    vmapped lane, folded with the round."""
    g = jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), r), shape)
    return torch.tensor(np.asarray(g), dtype=torch.float64, device=device)


@pytest.fixture(scope="module")
def views():
    return outlier_views()


@pytest.fixture(scope="module")
def jax_result(views):
    obj, uv, mask, _ = views
    opts = jr.RansacOptions(**OPTS)
    run = jax.jit(jax.vmap(lambda o, u, m: jr.ransac_homography(o, u, opts, mask=m)))
    return jax.device_get(run(obj, uv, mask))


def _port(views, lanes=slice(None)):
    obj, uv, mask, _ = views
    return tr.ransac_homography(
        t64(obj[lanes]), t64(uv[lanes]), tr.RansacOptions(**OPTS), mask=torch.tensor(mask[lanes])
    )


def test_ransac_matches_jax_with_jax_draws(views, jax_result, monkeypatch):
    monkeypatch.setattr(tr, "round_noise", jax_draws)
    got = _port(views)
    for name in ("success", "inlier_mask", "inlier_count", "iters"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(jax_result, name)), err_msg=name)
    np.testing.assert_allclose(got.model.numpy(), np.asarray(jax_result.model), rtol=1e-9)
    np.testing.assert_allclose(got.inlier_rms.numpy(), np.asarray(jax_result.inlier_rms), rtol=1e-9)
    iters = got.iters.numpy()
    assert iters[CLEAN] == 128 and iters[HEAVY] > 128  # per-lane stopping


def test_port_generator_recovers_planted_outliers(views, jax_result):
    _, _, mask, planted = views
    got = _port(views)
    assert got.success.all()
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(jax_result.inlier_mask))
    np.testing.assert_array_equal(got.inlier_mask.numpy(), mask & ~planted)


def test_lane_result_does_not_depend_on_batching(views):
    full = _port(views)
    lanes = [HEAVY, RAGGED]
    part = _port(views, lanes)
    for name in ("success", "inlier_mask", "inlier_count", "iters", "model", "inlier_rms"):
        assert torch.equal(getattr(part, name), getattr(full, name)[lanes]), name


def test_round_counter_counts_rounds_by_device(views):
    before = ransac_rounds("cpu")
    got = _port(views)
    # round 0 runs every lane; the heavy lane alone runs the later rounds
    assert ransac_rounds("cpu") - before == int(got.iters.max()) // 128


def test_round_noise_is_seeded_and_gumbel():
    a = tr.round_noise(7, 3, (128, 64), "cpu")
    assert a.shape == (128, 64) and a.dtype == torch.float64
    assert torch.equal(a, tr.round_noise(7, 3, (128, 64), "cpu"))
    assert not torch.equal(a, tr.round_noise(7, 4, (128, 64), "cpu"))
    assert abs(float(a.mean()) - 0.5772) < 0.05  # Euler-Mascheroni: the Gumbel mean


def test_calculate_iterations_matches_jax():
    rng = np.random.default_rng(3)
    ratio = np.concatenate([[0.0, 1.0, -0.1, 0.5, 0.95], rng.uniform(0, 1, 200)])
    for conf in (0.99, 0.5, 0.0, 1.0):
        for k in (3, 4):
            for so_far, max_it in ((0, 1000), (128, 1000), (384, 500)):
                want = np.asarray(jr.calculate_iterations(conf, jnp.asarray(ratio), k, so_far, max_it))
                got = tr.calculate_iterations(conf, torch.tensor(ratio), k, so_far, max_it).numpy()
                np.testing.assert_array_equal(got, want, err_msg=f"{conf} {k} {so_far} {max_it}")


def test_collinear_triplet_matches_jax():
    rng = np.random.default_rng(9)
    pts = rng.uniform(-1, 1, (64, 4, 2))
    pts[::4, 2] = 0.5 * (pts[::4, 0] + pts[::4, 1])  # exactly collinear triplets
    pts[1::4, 3] = pts[1::4, 0] + 1e-7  # near-coincident points
    want = np.asarray(jh.has_near_collinear_triplet(jnp.asarray(pts)))
    got = th.has_near_collinear_triplet(t64(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[::4].all() and want[1::4].all() and not want[2::4].all()
