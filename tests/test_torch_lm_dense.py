"""Port equivalence of the dense LM engine (calibration_tpu_torch.optim.lm:
``lm_core`` and ``covariance``) against the JAX engine vmapped over the
same problems, CPU, float64; and the torch Schur and dense engines held
equal to each other for intrinsics and extrinsics (the JAX package's
test_schur_solver_matches_dense and test_extrinsics_schur_matches_dense).

Problems: 6 homographies of 12 points (0.5 px noise, two gross outliers per
lane, inits pushed off the DLT so that trials are rejected) through the
reference's homography residual and forward-mode Jacobians; the dense
intrinsics solve (quaternion manifold, free mask, lower bounds).

Bars: iterations, linearizations and termination exactly equal per lane,
cost 1e-10 relative, x 1e-8, covariance 1e-8 relative to its largest
entry. Schur vs dense: camera 1e-7, cost 1e-9 relative, poses 1e-5 deg,
covariance 1e-4 relative (the JAX tests' bars).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth
from calibration_tpu.ops import homography as jH
from calibration_tpu.optim import ExtrinsicOptions as JExtrinsicOptions
from calibration_tpu.optim import IntrinsicsOptimOptions as JIntrOptions
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.optim import homography as jho
from calibration_tpu.optim import intrinsics as joi
from calibration_tpu.optim import lm as jlm
from calibration_tpu.optim.manifold import ProductManifold as JManifold
from calibration_tpu.optim.manifold import euclid as jeuclid
from calibration_tpu_torch import convert
from calibration_tpu_torch.optim import OptimOptions
from calibration_tpu_torch.optim import blocks as tblocks
from calibration_tpu_torch.optim import extrinsics as toe
from calibration_tpu_torch.optim import homography as tho
from calibration_tpu_torch.optim import intrinsics as toi
from calibration_tpu_torch.optim import lm as tlm
from calibration_tpu_torch.optim.manifold import ProductManifold, euclid
from torch_helpers import one_torch_thread, rel_fro, t64  # noqa: F401

B, N = 6, 12


def homography_problems(seed=3):
    rng = np.random.default_rng(seed)
    hs = np.tile(np.eye(3), (B, 1, 1))
    hs[:, 0, 0] = 1.0 + rng.uniform(-0.2, 0.2, B)
    hs[:, 1, 1] = 1.0 + rng.uniform(-0.2, 0.2, B)
    hs[:, :2, 2] = rng.uniform(-10, 10, (B, 2))
    hs[:, 2, :2] = rng.uniform(-2e-2, 2e-2, (B, 2))
    src = rng.uniform(-2, 2, (B, N, 2))
    ph = np.concatenate([src, np.ones((B, N, 1))], -1) @ np.swapaxes(hs, 1, 2)
    dst = ph[..., :2] / ph[..., 2:] + rng.normal(0, 0.5, (B, N, 2))
    dst[:, :2] += rng.uniform(5, 10, (B, 2, 2))  # gross outliers: Huber tails
    mask = np.ones((B, N))
    mask[1, -3:] = 0.0
    h0 = np.asarray(jax.vmap(jH.estimate_homography_dlt)(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask)))
    h0 = h0 / h0[:, 2:3, 2:3]
    h0[:, 2, :2] += rng.uniform(-0.03, 0.03, (B, 2))  # far enough off for rejected trials
    return src, dst, mask, h0


FREE = np.array([1, 0, 1, 1, 1, 1, 1, 1], bool)
CASES = {
    "huber": dict(options=dict(max_iterations=60, huber_delta=1.0)),
    "plain_lsq": dict(options=dict(max_iterations=60, huber_delta=0.0)),
    "budget_cut": dict(options=dict(max_iterations=3, epsilon=1e-12)),
    "free_mask_and_bounds": dict(options=dict(max_iterations=200), free=FREE, bounds=True),
    "scattered_blocks": dict(options=dict(max_iterations=60, huber_delta=2.0), blocks=(np.arange(2 * N) * 7) % 5),
}


def _spec_arrays(spec, h0):
    p0 = h0.reshape(B, 9)[:, :8]
    lower = upper = None
    if spec.get("bounds"):
        # an active upper bound on H00 and a loose lower one on H11
        upper = np.full((8,), np.inf)
        upper[0] = 0.9
        lower = np.full((8,), -np.inf)
        lower[4] = 0.5
    blocks = spec.get("blocks", np.repeat(np.arange(N), 2))
    nb = int(blocks.max()) + 1
    return p0, lower, upper, blocks, nb


@functools.lru_cache(maxsize=None)
def _solve_both(case):
    spec = CASES[case]
    src, dst, mask, h0 = homography_problems()
    p0, lower, upper, blocks, nb = _spec_arrays(spec, h0)
    free = spec.get("free")
    jman = JManifold([jeuclid(8)])

    def one(p, o, u, m):
        return jlm.lm_core(
            lambda x: jho._residual(x, o, u, m), p, jman, options=JOptimOptions(**spec["options"]),
            free_mask=None if free is None else jnp.asarray(free), block_ids=jnp.asarray(blocks, jnp.int32),
            num_blocks=nb, lower=None if lower is None else jnp.asarray(lower),
            upper=None if upper is None else jnp.asarray(upper),
        )

    jout = jax.device_get(jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (p0, src, dst, mask))))
    tout = tlm.lm_core(
        tho._residual, t64(p0), ProductManifold([euclid(8)]), data=(t64(src), t64(dst), t64(mask)),
        options=OptimOptions(**spec["options"]), free_mask=None if free is None else torch.tensor(free),
        block_ids=blocks, num_blocks=nb, lower=None if lower is None else t64(lower),
        upper=None if upper is None else t64(upper),
    )
    return jout, tout, (src, dst, mask, p0, free, blocks, nb, lower, upper)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_core_matches_jax(case):
    jout, tout, (_, _, _, p0, free, _, _, _, upper) = _solve_both(case)
    for name in ("iterations", "linearizations", "termination", "success"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
    np.testing.assert_allclose(tout.initial_cost.numpy(), jout.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(tout.cost.numpy(), jout.cost, rtol=1e-10)
    np.testing.assert_allclose(tout.x.numpy(), jout.x, rtol=1e-8, atol=1e-8)
    if case == "budget_cut":
        assert np.all(tout.iterations.numpy() == 3) and not bool(tout.success.any())
        return
    assert bool(tout.success.any())  # a lane may run out of budget: JAX's does too
    assert bool((tout.iterations > tout.linearizations).any()), "some trials should be rejected"
    if free is not None:
        np.testing.assert_array_equal(tout.x[:, ~free].numpy(), p0[:, ~free])
    if upper is not None:
        assert bool((tout.x[:, 0] <= 0.9).all()) and bool((tout.x[:, 0] == 0.9).any())


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "scaled_by_variance"])
def test_covariance_matches_jax(scaled):
    """Huber-rescaled covariance with a frozen coordinate, and the
    homography's ssr / (m - n) scaling with the valid-row count."""
    jout, tout, (src, dst, mask, _, _, blocks, nb, _, _) = _solve_both("free_mask_and_bounds")
    m = 2.0 * mask.sum(-1)
    kw = dict(block_ids=blocks, num_blocks=nb, huber_delta=1.0, scale_by_variance=scaled)
    got, ok = tlm.covariance(
        tho._residual, tout.x, ProductManifold([euclid(8)]), data=(t64(src), t64(dst), t64(mask)),
        free_mask=torch.tensor(FREE), num_residuals=t64(m) if scaled else None, **kw,
    )
    assert bool(ok.all())
    jman = JManifold([jeuclid(8)])
    for i in range(B):
        want, ok_j = jlm.covariance(
            lambda x: jho._residual(x, jnp.asarray(src[i]), jnp.asarray(dst[i]), jnp.asarray(mask[i])),
            jnp.asarray(tout.x[i].numpy()), jman, free_mask=jnp.asarray(FREE),
            num_residuals=m[i] if scaled else None, **dict(kw, block_ids=jnp.asarray(blocks, jnp.int32)),
        )
        assert bool(ok_j)
        assert np.abs(got[i].numpy() - np.asarray(want)).max() <= 1e-8 * np.abs(want).max()
        assert np.all(got[i].numpy()[1] == 0.0)  # the frozen coordinate


def test_jacfwd_matches_jax():
    """The forward-mode tangent Jacobian of a quaternion-manifold residual
    (the dense intrinsics one) against JAX's jacfwd, at 1e-10."""
    obj, uv, intr0, mask, poses0, _ = _intrinsics_problem(2)
    v = obj.shape[1]
    jman = joi.make_manifold(10, v)
    x0 = tblocks.pack_intr_quats_trans(t64(intr0), *tblocks.poses_to_quat_tran(t64(poses0))).numpy()
    _, got = tlm.tangent_jacobian(toi._residual_flat, toi.make_manifold(10, v), t64(x0), (t64(obj), t64(uv), t64(mask)))
    for i in range(2):
        rt = lambda d: joi._residual_flat(  # noqa: E731
            joi.PINHOLE, jman.retract(jnp.asarray(x0[i]), d), jnp.asarray(obj[i]), jnp.asarray(uv[i]),
            jnp.asarray(mask[i]), 10, v,
        )
        want = np.asarray(jax.jacfwd(rt)(jnp.zeros(jman.tangent_dim)))
        scale = np.maximum(1.0, np.abs(want))
        np.testing.assert_allclose(got[i].numpy() / scale, want / scale, atol=1e-10)


def _intrinsics_problem(b, seed=11):
    """b cameras x 6 views of a 6x8 grid at 0.3 px noise, plus one junk
    view frozen through view_valid (test_schur_solver_matches_dense's
    setup); the inits off the truth. Returns (obj, uv, x0, mask, poses0,
    view_valid)."""
    rng = np.random.default_rng(seed)
    intr_gt = synth.default_camera()
    grid = synth.make_target_grid(6, 8, 0.04)
    obj, uv, x0, poses0 = [], [], [], []
    for i in range(b):
        poses = synth.circle_views(6, tilt=0.3 + 0.02 * i)
        u = synth.render_pixels(intr_gt, poses, grid, noise=0.3, rng=rng)
        obj.append(np.tile(grid[None], (7, 1, 1)))
        uv.append(np.concatenate([u, rng.uniform(0, 640, (1,) + u.shape[1:])]))
        p0 = np.concatenate([poses, np.eye(4)[None]])
        p0[6, 2, 3] = 1.0
        poses0.append(p0)
        intr0 = intr_gt.copy()
        intr0[:4] += [8.0, -6.0, 4.0, -3.0]
        intr0[5:] = 0.0
        x0.append(intr0)
    view_valid = np.tile(np.arange(7) < 6, (b, 1))
    return np.stack(obj), np.stack(uv), np.stack(x0), view_valid[..., None] * np.ones(grid.shape[0]), np.stack(poses0), view_valid


@pytest.fixture(scope="module")
def intrinsics_solves():
    """The port's dense and Schur intrinsics solves of 2 cameras (covariance
    on), and JAX's dense solve of the first."""
    obj, uv, intr0, mask, poses0, view_valid = _intrinsics_problem(2)
    args = (t64(obj), t64(uv), t64(intr0), t64(poses0))
    opts = convert.intrinsics_options(JIntrOptions())
    out = {s: toi.optimize_intrinsics_device(*args, opts=opts, view_valid=torch.tensor(view_valid), solver=s)
           for s in ("dense", "schur")}
    jax_dense = jax.device_get(joi.optimize_intrinsics_device(
        *(jnp.asarray(a[0]) for a in (obj, uv, intr0, poses0)), view_valid=jnp.asarray(view_valid[0]),
        opts=JIntrOptions(), solver="dense",
    ))
    return out, jax_dense, poses0


def test_dense_intrinsics_matches_jax(intrinsics_solves):
    out, jd, _ = intrinsics_solves
    got = out["dense"]
    for name in ("iterations", "linearizations", "termination"):
        assert int(getattr(got[0], name)[0]) == int(getattr(jd[0], name)), name
    np.testing.assert_allclose(float(got[0].cost[0]), float(jd[0].cost), rtol=1e-10)
    np.testing.assert_allclose(got[1][0].numpy(), jd[1], rtol=1e-8)
    assert rel_fro(got[4][0].numpy(), jd[4]) < 1e-6


def test_schur_solver_matches_dense(intrinsics_solves):
    """The Schur engine is exact block elimination of the same damped
    system: the same camera as the dense engine to roundoff, a padded and
    frozen view untouched by both, the block covariance equal to the dense
    one."""
    out, _, poses0 = intrinsics_solves
    (d_lm, d_intr, d_poses, _, d_cov, d_ok), (s_lm, s_intr, s_poses, _, s_cov, s_ok) = out["dense"], out["schur"]
    assert bool(d_lm.success.all()) and bool(s_lm.success.all()) and bool(d_ok.all()) and bool(s_ok.all())
    np.testing.assert_allclose(s_intr.numpy(), d_intr.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(s_lm.cost.numpy(), d_lm.cost.numpy(), rtol=1e-9)
    for i in range(2):
        for v in range(6):
            assert synth.rot_err_deg(s_poses[i, v].numpy(), d_poses[i, v].numpy()) < 1e-5
        np.testing.assert_allclose(s_poses[i, 6].numpy(), poses0[i, 6], atol=1e-12)
        np.testing.assert_allclose(d_poses[i, 6].numpy(), poses0[i, 6], atol=1e-12)
    np.testing.assert_allclose(s_cov.numpy(), d_cov.numpy(), rtol=1e-4, atol=1e-12)


def test_extrinsics_schur_matches_dense():
    """Manifold-global Schur (intrinsics + camera quaternions in the global
    block, target poses eliminated) lands on the dense engine's solution,
    the gauge kept."""
    rng = np.random.default_rng(21)
    intr_gt = synth.default_camera()
    obj = synth.make_target_grid(5, 7, 0.05)
    c1_se3_c0 = synth.euler_pose(0.02, -0.35, 0.01, [-0.22, 0.01, 0.015])
    r_se3_t = synth.circle_views(6, dist=1.0)
    n = obj.shape[0]
    uv = np.zeros((6, 2, n, 2))
    for v in range(6):
        for ci, cpose in enumerate([r_se3_t[v], c1_se3_c0 @ r_se3_t[v]]):
            uv[v, ci] = synth.render_pixels(intr_gt, cpose[None], obj, noise=0.3, rng=rng)[0]
    obj_b = np.tile(obj[None, None], (6, 2, 1, 1))
    cams0 = np.stack([intr_gt, intr_gt])
    cams0[:, 0] += 5.0
    c_se3_r0 = np.stack([np.eye(4), synth.euler_pose(0.01, -0.33, 0.02, [-0.2, 0.0, 0.0])])
    opts = convert.extrinsic_options(JExtrinsicOptions())
    args = (t64(obj_b), t64(uv), t64(cams0), t64(c_se3_r0), t64(r_se3_t))
    dense = toe.optimize_extrinsics(*args, opts=opts, solver="dense")
    schur = toe.optimize_extrinsics(*args, opts=opts, solver="schur")
    assert dense.core.success and schur.core.success
    np.testing.assert_allclose(schur.cameras, dense.cameras, rtol=0, atol=1e-7)
    np.testing.assert_allclose(schur.core.final_cost, dense.core.final_cost, rtol=1e-9)
    for ci in range(2):
        assert synth.rot_err_deg(schur.c_se3_r[ci], dense.c_se3_r[ci]) < 1e-5
        assert synth.trans_err(schur.c_se3_r[ci], dense.c_se3_r[ci]) < 1e-8
    np.testing.assert_allclose(schur.c_se3_r[0], np.eye(4), atol=1e-12)
    np.testing.assert_allclose(schur.r_se3_t[0], r_se3_t[0], atol=1e-12)
    np.testing.assert_allclose(dense.r_se3_t[0], r_se3_t[0], atol=1e-12)
    np.testing.assert_allclose(schur.core.covariance, dense.core.covariance, rtol=1e-4, atol=1e-12)


def test_unknown_solver_raises():
    obj, uv, intr0, mask, poses0, _ = _intrinsics_problem(1)
    with pytest.raises(ValueError, match="unknown solver"):
        toi.optimize_intrinsics_device(t64(obj), t64(uv), t64(intr0), t64(poses0), solver="qr")
