"""Port equivalence of the variable-projection slice: the distortion fits
(``models/distortion.py``), the normalized-observation linear intrinsics
(``ops/intrinsics_linear.py``), VarPro planar pose (``optim/planarpose.py``,
``parallel/batched.planar_pose_batch``) and semi-DLT
(``optim/semidlt.py``) against the JAX package, CPU, float64.

Data: numpy from fixed seeds, a 4x5 grid at 0.04 m, 3 planar-pose problems
and 5-view semi-DLT cameras. JAX compiles two LM programs here, one
planar-pose lane and one semi-DLT camera (p1, p2 pinned, K boxed), each
jitted once per module, as a CPU compile of an LM costs seconds.

Bars: the fits and the linear intrinsics within 1e-10 relative of their
largest entry; the solves with equal iterations, linearizations and
termination, final cost within 1e-10 relative, poses within 1e-9 and the
covariance within 1e-8 of its largest entry. Padding with masked rows
changes nothing (the reference's own padding tests), and both forward-mode
Jacobians of the VarPro residual (dual numbers and vmap) agree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth
from calibration_tpu.models import camera_matrix as jcm
from calibration_tpu.models import CalibrationBounds as JBounds
from calibration_tpu.models import distortion as jdist
from calibration_tpu.ops import intrinsics_linear as jlin
from calibration_tpu.optim import IntrinsicsOptimOptions as JOpts
from calibration_tpu.optim import OptimOptions as JCore
from calibration_tpu.optim import semidlt as jsd
from calibration_tpu.ops import planarpose as jops_pp
from calibration_tpu.optim import planarpose as jpp
from calibration_tpu_torch.models import CalibrationBounds as TBounds
from calibration_tpu_torch.models import distortion as tdist
from calibration_tpu_torch.ops import intrinsics_linear as tlin
from calibration_tpu_torch.ops import planarpose as tops_pp
from calibration_tpu_torch.ops import se3 as tse3
from calibration_tpu_torch.optim import IntrinsicsOptimOptions as TOpts
from calibration_tpu_torch.optim import OptimOptions as TCore
from calibration_tpu_torch.optim import lm as tlm
from calibration_tpu_torch.optim import planarpose as tpp
from calibration_tpu_torch.optim import semidlt as tsd
from calibration_tpu_torch.parallel import batched as tbatched
from torch_helpers import one_torch_thread, t64  # noqa: F401

K = np.array([600.0, 620.0, 320.0, 240.0, 0.5])
COEFFS = np.array([-0.2, 0.05, 1e-4, -2e-4])  # k1, k2, p1, p2


def _close(got, want, rtol=1e-10):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _fit_points(seed, n, noise=0.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.4, 0.4, (n, 2))
    uv = np.asarray(jcm.denormalize(jnp.asarray(K), jdist.apply_distortion(jnp.asarray(xy), jnp.asarray(COEFFS))))
    return xy, uv + rng.normal(0, noise, uv.shape)


def _both(fn, *args, **kw):
    """fn's JAX (jitted: eager JAX compiles op by op) and port results on
    the same numpy arguments: (jax, port). The int and float arguments are
    static."""
    conv = lambda a, f: f(a) if isinstance(a, np.ndarray) else a  # noqa: E731
    static = [i for i, a in enumerate(args) if not isinstance(a, np.ndarray)]
    jfn = jax.jit(getattr(jdist, fn), static_argnums=static,
                  static_argnames=[k for k, v in kw.items() if not isinstance(v, np.ndarray)])
    want = jfn(*(conv(a, jnp.asarray) for a in args), **{k: conv(v, jnp.asarray) for k, v in kw.items()})
    got = getattr(tdist, fn)(*(conv(a, t64) for a in args), **{k: conv(v, torch.as_tensor) for k, v in kw.items()})
    return want, got


def _fit_exact():
    xy, uv = _fit_points(3, 40)
    return _both("fit_distortion_full", xy, uv, K, 2)


def _fit_pinned():
    xy, uv = _fit_points(4, 50)
    return _both("fit_distortion_full", xy, uv, K, 2, fixed_mask=np.array([True, False, False, True]),
                 fixed_values=np.array([-0.2, 0.0, 0.0, -1e-4]))


def _fit_insufficient():
    xy, uv = _fit_points(5, 7)
    return _both("fit_distortion", xy, uv, K, 2)


def _fit_masked_ridge():
    xy, uv = _fit_points(6, 30, noise=0.05)
    mask = np.ones(30, bool)
    mask[20:] = False
    return _both("fit_distortion_full", xy, uv, K, 3, mask=mask, ridge=1e-9)


def _fit_inverse():
    return (jax.jit(jdist.invert_brown_conrady)(jnp.asarray(COEFFS)),), (tdist.invert_brown_conrady(t64(COEFFS)),)


def _fit_dual():
    xy, uv = _fit_points(7, 35, noise=0.05)
    mask = np.ones(35, bool)
    mask[::6] = False
    return _both("fit_distortion_dual", xy, uv, K, 2, mask=mask)


FIT_CASES = {
    "exact": _fit_exact, "pinned": _fit_pinned, "insufficient": _fit_insufficient,
    "masked_ridge": _fit_masked_ridge, "inverse": _fit_inverse, "dual": _fit_dual,
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_distortion_fits_match_jax(case):
    want, got = FIT_CASES[case]()
    assert len(want) == len(got)
    for w, g in zip(want, got):
        if np.asarray(w).dtype == bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)
    if case == "exact":
        _close(got[0], COEFFS, rtol=1e-9)
        assert bool(got[2])
    elif case == "pinned":  # the pinned slots are exact
        assert got[0][0].item() == -0.2 and got[0][3].item() == -1e-4
    elif case == "insufficient":
        assert not bool(got[2])


def test_masked_fit_equals_the_subset():
    xy, uv = _fit_points(8, 30, noise=0.05)
    mask = np.ones(30, bool)
    mask[20:] = False
    masked = tdist.fit_distortion_full(t64(xy), t64(uv), t64(K), 2, mask=torch.as_tensor(mask))
    subset = tdist.fit_distortion_full(t64(xy[:20]), t64(uv[:20]), t64(K), 2)
    _close(masked[0], subset[0].numpy(), rtol=1e-12)
    assert not bool(masked[1][40:].any())


def test_fit_is_batched_forward_differentiable_and_nan_when_not_spd():
    """Lanes of a batch are the single fits; forward mode through the fit
    equals JAX's jacfwd; a degenerate lane gives NaN and not ok, without
    raising."""
    xy, uv = _fit_points(9, 24, noise=0.05)
    xs = np.stack([xy, 1.1 * xy, np.zeros_like(xy)])
    batch = tdist.fit_distortion_full(t64(xs), t64(np.stack([uv] * 3)), t64(K), 2)
    _close(batch[0][0], tdist.fit_distortion_full(t64(xy), t64(uv), t64(K), 2)[0].numpy(), rtol=1e-12)
    assert bool(torch.isnan(batch[0][2]).all()) and batch[2].tolist() == [True, True, False]

    def port(k):
        return tdist.fit_distortion_full(t64(xy), t64(uv), k, 2)[0]

    got = torch.func.jacfwd(port)(t64(K))
    want = jax.jit(jax.jacfwd(lambda k: jdist.fit_distortion_full(jnp.asarray(xy), jnp.asarray(uv), k, 2)[0]))(
        jnp.asarray(K))
    _close(got, want, rtol=1e-9)


def _linear_case(name):
    rng = np.random.default_rng(10)
    kmtx = np.array([700.0, 710.0, 330.0, 250.0, 0.004])
    xy = rng.uniform(-0.4, 0.4, (60, 2))
    uv = np.stack([kmtx[0] * xy[:, 0] + kmtx[4] * xy[:, 1] + kmtx[2], kmtx[1] * xy[:, 1] + kmtx[3]], -1)
    uv = uv + rng.normal(0, 1e-3, uv.shape)
    mask = np.ones(60, bool)
    mask[::7] = False
    if name == "plain":
        return (xy, uv), {}
    if name == "skew_masked":
        return (xy, uv), dict(mask=mask, use_skew=True)
    # fx = 2450 lies above the default fx_max: the fallback heuristics
    return (xy, uv * [3.5, 1.0]), dict(mask=mask)


@pytest.mark.parametrize("name", ["plain", "skew_masked", "fallback"])
def test_estimate_intrinsics_linear_matches_jax(name):
    (xy, uv), kw = _linear_case(name)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want = jax.jit(jlin.estimate_intrinsics_linear, static_argnames=("use_skew",))(
        jnp.asarray(xy), jnp.asarray(uv), **jkw)
    got = tlin.estimate_intrinsics_linear(t64(xy), t64(uv), **tkw)
    _close(got[0], want[0])
    assert bool(got[1]) and bool(want[1])
    if name == "fallback":  # fx clamped into the box, cx and cy at half the mean pixel
        assert got[0][0].item() == TBounds().fx_max
        _close(got[0][2], np.mean(uv[kw["mask"], 0]) / 2.0, rtol=1e-12)


def test_estimate_intrinsics_linear_degenerate_and_batched():
    """Fewer than two valid rows is not ok; a batch's lanes are the single
    fits."""
    (xy, uv), _ = _linear_case("plain")
    mask = np.zeros((2, 60), bool)
    mask[0] = True
    mask[1, 0] = True
    got = tlin.estimate_intrinsics_linear(t64(np.stack([xy] * 2)), t64(np.stack([uv] * 2)), mask=torch.as_tensor(mask))
    assert got[1].tolist() == [True, False]
    _close(got[0][0], tlin.estimate_intrinsics_linear(t64(xy), t64(uv))[0].numpy(), rtol=1e-12)
    want = jlin.estimate_intrinsics_linear(jnp.asarray(xy), jnp.asarray(uv), mask=jnp.asarray(mask[1]))
    assert bool(want[1]) is False


def test_estimate_intrinsics_linear_iterative_matches_jax():
    rng = np.random.default_rng(6)
    intr = synth.default_camera()
    intr[7] = 0.0  # k3: the fit has two radial terms
    xy = rng.uniform(-0.35, 0.35, (120, 2))
    dxy = jdist.apply_distortion(jnp.asarray(xy), jnp.asarray(intr[[5, 6, 8, 9]]))
    uv = np.asarray(jcm.denormalize(jnp.asarray(intr[:5]), dxy)) + rng.normal(0, 0.05, xy.shape)
    want = jax.jit(jlin.estimate_intrinsics_linear_iterative, static_argnames=("num_radial",))(
        jnp.asarray(xy), jnp.asarray(uv), num_radial=2)
    got = tlin.estimate_intrinsics_linear_iterative(t64(xy), t64(uv), num_radial=2)
    for w, g in zip(want[:2], got[:2]):
        _close(g, w)
    assert bool(got[2]) and bool(want[2])
    np.testing.assert_allclose(got[0][:4].numpy(), intr[:4], rtol=2e-2)


# --- planar pose ---------------------------------------------------------

PP_B = 3


def _planar_problems(noise=0.3, seed=21):
    """PP_B problems: (obj (B, N, 2), uv, kmtx (B, 5), poses (B, 4, 4)),
    each a differently tilted view through a distorted camera (k3 = 0)."""
    rng = np.random.default_rng(seed)
    intr = synth.default_camera()
    intr[5:] = [-0.12, 0.04, 0.0, 1e-4, -5e-5]
    obj = synth.make_target_grid(4, 5, 0.04)
    poses = np.stack([synth.euler_pose(0.25 - 0.1 * i, -0.1 + 0.05 * i, 0.08, [0.03, -0.02, 1.1 + 0.05 * i])
                      for i in range(PP_B)])
    uv = np.stack([synth.render_pixels(intr, p[None], obj, noise=noise, rng=rng)[0] for p in poses])
    return np.broadcast_to(obj, uv.shape).copy(), uv, np.tile(intr[:5], (PP_B, 1)), poses


def _assert_lm_equal(tout, jout):
    for name in ("iterations", "linearizations", "termination", "success"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
    np.testing.assert_allclose(tout.cost.numpy(), np.asarray(jout.cost), rtol=1e-10)
    np.testing.assert_allclose(tout.initial_cost.numpy(), np.asarray(jout.initial_cost), rtol=1e-10)


def _assert_cov_close(got, want, rtol=1e-8):
    want = np.asarray(want)
    scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
    assert np.all(np.abs(np.asarray(got) - want) <= rtol * scale)


@pytest.fixture(scope="module")
def planar_runs():
    """JAX's planar_pose_batch, as its lanes (its planar-pose seed, then its
    optimize_planar_pose_device jitted once for one lane: a vmapped compile
    costs twice as much), and the port's on the same problems."""
    obj, uv, kmtx, _ = _planar_problems()
    seed = jops_pp.estimate_planar_pose(jnp.asarray(obj), jnp.asarray(uv), jnp.asarray(kmtx))
    lane = jax.jit(jpp.optimize_planar_pose_device, static_argnames=("num_radial", "options"))
    lanes = [jax.device_get(lane(seed[i], obj[i], uv[i], kmtx[i], num_radial=2)) for i in range(PP_B)]
    jout = jax.tree_util.tree_map(lambda *a: np.stack(a), *lanes)
    tout = tbatched.planar_pose_batch(t64(obj), t64(uv), t64(kmtx))
    return jout, tout


def test_planar_pose_batch_matches_jax(planar_runs):
    jout, tout = planar_runs
    _assert_lm_equal(tout[0], jout[0])
    assert bool(tout[0].success.all())
    _close(tout[1], jout[1], rtol=1e-9)  # pose
    _close(tout[2], jout[2], rtol=1e-9)  # distortion
    _assert_cov_close(tout[3], jout[3])
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    np.testing.assert_allclose(tout[5].numpy(), np.asarray(jout[5]), rtol=1e-10)


def test_optimize_planar_pose_is_a_lane_of_the_batch(planar_runs):
    """The host wrapper, from the batch's own seed, gives lane 1 of the
    batch (and so of JAX's)."""
    _, tout = planar_runs
    obj, uv, kmtx, _ = _planar_problems()
    seed = tops_pp.estimate_planar_pose(t64(obj), t64(uv), t64(kmtx))
    res = tpp.optimize_planar_pose(t64(obj[1]), t64(uv[1]), t64(kmtx[1]), seed[1])
    assert res.core.success and res.core.iterations == int(tout[0].iterations[1])
    np.testing.assert_allclose(res.core.final_cost, float(tout[0].cost[1]), rtol=1e-12)
    _close(res.pose, tout[1][1].numpy(), rtol=1e-12)
    _close(res.core.covariance, tout[3][1].numpy(), rtol=1e-10)
    assert abs(res.reprojection_error - float(tout[5][1])) <= 1e-12


def test_planar_pose_padding_invariance():
    """Padded (mask = 0) rows are the same as dropping them: the solution,
    the RMS over valid rows and the variance-scaled covariance."""
    obj, uv, kmtx, truth = _planar_problems(seed=22)
    rng = np.random.default_rng(23)
    pert = truth[0] @ synth.euler_pose(0.02, -0.02, 0.005, [0.005, -0.002, 0.02])
    pad = 6
    obj_p = np.concatenate([obj[0], rng.uniform(-1, 1, (pad, 2))])
    uv_p = np.concatenate([uv[0], rng.uniform(0, 640, (pad, 2))])
    mask_p = np.concatenate([np.ones(obj.shape[1]), np.zeros(pad)])
    plain = tpp.optimize_planar_pose(t64(obj[0]), t64(uv[0]), t64(kmtx[0]), t64(pert))
    padded = tpp.optimize_planar_pose(t64(obj_p), t64(uv_p), t64(kmtx[0]), t64(pert), mask=t64(mask_p))
    assert padded.core.success and padded.core.iterations == plain.core.iterations
    np.testing.assert_allclose(padded.pose, plain.pose, atol=1e-10)
    np.testing.assert_allclose(padded.reprojection_error, plain.reprojection_error, rtol=1e-12)
    assert plain.reprojection_error > 0.1
    np.testing.assert_allclose(padded.core.covariance, plain.core.covariance, rtol=1e-8)


def test_varpro_jacobians_agree():
    """The dual-number Jacobian of the VarPro residual equals
    ``tangent_jacobian``'s vmap(jacfwd) to roundoff, for planar pose and
    semi-DLT (its bounds clip in both)."""
    obj, uv, kmtx, truth = _planar_problems()
    x = tse3.se3_log(t64(truth))

    def res(p, o, u, k, m):
        return tpp._vp_residual(p, o, u, k, m, 2)

    data = (t64(obj), t64(uv), t64(kmtx), torch.ones(obj.shape[:2], dtype=torch.float64))
    _, want = tlm.tangent_jacobian(res, tpp._MANIFOLD, x, data)
    got = tlm.dual_jacobian_fn(res, tpp._MANIFOLD)(x, *data)
    _close(got, want.numpy(), rtol=1e-12)

    sobj, suv, k0, _ = _semidlt_views()
    opts = TOpts()
    fm, fv = tsd._fixed_arrays(opts, 4)
    v = sobj.shape[0]
    manifold = tsd.make_manifold(5, v)
    poses = tops_pp.estimate_planar_pose(t64(sobj), t64(suv), t64(k0).expand(v, 5))
    q, t = tsd.blocks.poses_to_quat_tran(poses)
    xs = tsd.blocks.pack_intr_quats_trans(t64(k0)[None], q[None], t[None])
    lower = torch.cat([torch.tensor([0.0, 0.0, 0.0, 0.0, -0.01], dtype=torch.float64), torch.full((7 * v,), -torch.inf)])

    def sres(xx, o, u, m):
        return tsd._vp_fit(xx, o, u, m, 2, fm, fv)[3][1]

    sdata = (t64(sobj)[None], t64(suv)[None], torch.ones(sobj.shape[:2], dtype=torch.bool)[None])
    _, want = tlm.tangent_jacobian(sres, manifold, xs, sdata, lower=lower)
    got = tlm.dual_jacobian_fn(sres, manifold, lower=lower)(xs, *sdata)
    _close(got, want.numpy(), rtol=1e-12)


# --- semi-DLT ------------------------------------------------------------

def _semidlt_views(v=5, noise=0.2, seed=22):
    """(obj (V, N, 2), uv, perturbed K (5,), truth (10,)), k3 = p1 = p2 = 0."""
    rng = np.random.default_rng(seed)
    intr = synth.default_camera()
    intr[5:] = [-0.1, 0.03, 0.0, 0.0, 0.0]
    obj = synth.make_target_grid(4, 5, 0.04)
    uv = synth.render_pixels(intr, synth.circle_views(v), obj, noise=noise, rng=rng)
    k0 = intr[:5] + np.array([10.0, -8.0, 5.0, -4.0, 0.0])
    return np.tile(obj[None], (v, 1, 1)), uv, k0, intr


SEMIDLT_CASES = {
    # p1, p2 pinned at 0 and K boxed (the default options run in the
    # padding test and on the card)
    "pinned_bounded": (dict(fixed_distortion_indices=(2, 3), fixed_distortion_values=(0.0, 0.0)),
                       dict(fx_min=100.0, fx_max=1500.0, fy_min=100.0, fy_max=1500.0, cx_min=100.0, cx_max=600.0,
                            cy_min=100.0, cy_max=400.0)),
}


def _semidlt_opts(pkg_opts, pkg_core, bounds_cls, case):
    extra, bounds = SEMIDLT_CASES[case]
    return pkg_opts(core=pkg_core(max_iterations=60), bounds=bounds_cls(**bounds) if bounds else None, **extra)


@pytest.fixture(scope="module")
def semidlt_runs():
    """JAX's host semi-DLT with its device function jitted (one compile per
    options), and the port's, per case."""
    obj, uv, k0, _ = _semidlt_views()
    jitted = jax.jit(jsd.optimize_intrinsics_semidlt_device, static_argnames=("opts",))
    mp = pytest.MonkeyPatch()
    mp.setattr(jsd, "optimize_intrinsics_semidlt_device", jitted)
    try:
        runs = {}
        for case in SEMIDLT_CASES:
            jres = jsd.optimize_intrinsics_semidlt(obj, uv, k0, opts=_semidlt_opts(JOpts, JCore, JBounds, case))
            tres = tsd.optimize_intrinsics_semidlt(t64(obj), t64(uv), t64(k0),
                                                   opts=_semidlt_opts(TOpts, TCore, TBounds, case))
            runs[case] = (jres, tres)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize("case", sorted(SEMIDLT_CASES))
def test_semidlt_matches_jax(semidlt_runs, case):
    jres, tres = semidlt_runs[case]
    assert tres.core.success and jres.core.success
    assert (tres.core.iterations, tres.core.termination) == (jres.core.iterations, jres.core.termination)
    np.testing.assert_allclose(tres.core.final_cost, jres.core.final_cost, rtol=1e-10)
    np.testing.assert_allclose(tres.core.initial_cost, jres.core.initial_cost, rtol=1e-10)
    _close(tres.kmtx, jres.kmtx, rtol=1e-9)
    _close(tres.distortion, jres.distortion, rtol=1e-9)
    _close(tres.c_se3_t, jres.c_se3_t, rtol=1e-9)
    _close(tres.view_errors, jres.view_errors, rtol=1e-9)
    _assert_cov_close(tres.core.covariance, jres.core.covariance)
    if case == "pinned_bounded":
        assert tres.distortion[2] == 0.0 and tres.distortion[3] == 0.0


def test_semidlt_device_lanes_and_padding():
    """optimize_intrinsics_semidlt_device's lanes are single cameras, and a
    padded camera (masked rows) solves as the unpadded one."""
    obj, uv, k0, _ = _semidlt_views()
    rng = np.random.default_rng(24)
    pad = 4
    obj_p = np.concatenate([obj, rng.uniform(-1, 1, (5, pad, 2))], axis=1)
    uv_p = np.concatenate([uv, rng.uniform(0, 640, (5, pad, 2))], axis=1)
    mask_p = np.concatenate([np.ones(obj.shape[:2]), np.zeros((5, pad))], axis=1).astype(bool)
    plain = tsd.optimize_intrinsics_semidlt(t64(obj), t64(uv), t64(k0))
    padded = tsd.optimize_intrinsics_semidlt(t64(obj_p), t64(uv_p), t64(k0), mask=torch.as_tensor(mask_p))
    assert padded.core.success and padded.core.iterations == plain.core.iterations
    np.testing.assert_allclose(padded.kmtx, plain.kmtx, atol=1e-8)
    np.testing.assert_allclose(padded.view_errors, plain.view_errors, rtol=1e-10)
    assert plain.view_errors.max() > 0.05
    np.testing.assert_allclose(padded.core.covariance, plain.core.covariance, rtol=1e-6)

    both = tsd.optimize_intrinsics_semidlt_device(
        t64(np.stack([obj_p, obj_p])), t64(np.stack([uv_p, uv_p])), t64(np.stack([k0, k0 + 1.0])),
        mask=torch.as_tensor(np.stack([mask_p, mask_p])),
    )
    assert int(both[0].iterations[0]) == padded.core.iterations
    np.testing.assert_allclose(both[1][0].numpy(), padded.kmtx, rtol=1e-12)
    assert bool(both[0].success.all()) and both[5].shape == (2, 40, 40)


def test_semidlt_value_errors():
    obj, uv, k0, _ = _semidlt_views(v=3)
    with pytest.raises(ValueError, match="at least 4 required"):
        tsd.optimize_intrinsics_semidlt(t64(obj), t64(uv), t64(k0))
    obj, uv, k0, _ = _semidlt_views()
    for bad in (-1, 4):
        with pytest.raises(ValueError, match="Fixed distortion index out of range"):
            tsd.optimize_intrinsics_semidlt(t64(obj), t64(uv), t64(k0), opts=TOpts(fixed_distortion_indices=(bad,)))
    # the port's _fixed_arrays is the reference's
    opts = dataclasses.replace(TOpts(), fixed_distortion_indices=(3, 0), fixed_distortion_values=(0.5,))
    jm, jv = jsd._fixed_arrays(JOpts(fixed_distortion_indices=(3, 0), fixed_distortion_values=(0.5,)), 4)
    tm, tv = tsd._fixed_arrays(opts, 4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
