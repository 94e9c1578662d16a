"""Port equivalence of the stereo / multi-camera extrinsics solve, CPU,
float64: the SE(3) additions, the linear seed ``estimate_extrinsic_dlt``,
the analytic rig Jacobian, the Schur LM with a manifold-valued global block
and one Huber block per (view, camera) pair, ``optimize_extrinsics`` with
covariance, and ``extrinsics_batch`` single-phase and phased, each against
its JAX counterpart on the same numpy inputs.

Bars: SE(3) ops and the seed 1e-9 absolute; the Jacobian 1e-10 relative
(to max(1, |entry|)); solves with iterations, linearizations and
termination exactly equal per lane, final cost 1e-10 relative, cameras and
poses 1e-8 relative, covariance 1e-6 relative to its largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth
from calibration_tpu.models import camera_matrix as jcm
from calibration_tpu.models.registry import PINHOLE as JPINHOLE
from calibration_tpu.ops import extrinsics_linear as jel
from calibration_tpu.ops import se3 as jse3
from calibration_tpu.optim import ExtrinsicOptions as JExtrinsicOptions
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.optim import extrinsics as jext
from calibration_tpu.optim import lm_schur as jlm
from calibration_tpu.parallel import batched as jbatched
from calibration_tpu_torch import convert
from calibration_tpu_torch.models import camera_matrix as tcm
from calibration_tpu_torch.ops import extrinsics_linear as tel
from calibration_tpu_torch.ops import se3 as tse3
from calibration_tpu_torch.optim import blocks as tblocks
from calibration_tpu_torch.optim import extrinsics as text
from calibration_tpu_torch.optim import lm_schur as tlm
from calibration_tpu_torch.parallel import batched as tbatched
from torch_helpers import one_torch_thread, t64  # noqa: F401

PC = 10
OFFSETS = (
    np.eye(4),
    synth.euler_pose(0.02, -0.3, 0.01, [-0.2, 0.01, 0.015]),
    synth.euler_pose(-0.01, 0.25, -0.02, [0.18, 0.03, -0.01]),
)


def rigs(b, v, c, noise=0.2, seed=3):
    """B rigs of C cameras x V views of a 5x7 grid (0.05 m): (obj, uv
    (B, V, C, N, 2), mask (B, V, C, N), init cameras (B, C, pc), init
    c_se3_r (B, C, 4, 4), init r_se3_t (B, V, 4, 4), true c_se3_r). Each
    rig has its own camera offsets and view circle, so lanes converge at
    different iterations; the inits are perturbed off the truth."""
    rng = np.random.default_rng(seed)
    intr = synth.default_camera()
    grid = synth.make_target_grid(5, 7, 0.05)
    n = grid.shape[0]
    uv = np.zeros((b, v, c, n, 2))
    c_true = np.zeros((b, c, 4, 4))
    r_true = np.zeros((b, v, 4, 4))
    for i in range(b):
        r_true[i] = synth.circle_views(v, dist=1.0, tilt=0.25 + 0.03 * i)
        for ci in range(c):
            c_true[i, ci] = OFFSETS[ci] @ synth.euler_pose(0.0, 0.01 * i * ci, 0.0, [0.004 * i * ci, 0, 0])
            uv[i, :, ci] = synth.render_pixels(intr, c_true[i, ci] @ r_true[i], grid, noise=noise, rng=rng)
    obj = np.broadcast_to(grid, (b, v, c, n, 2)).copy()
    mask = np.ones((b, v, c, n))
    mask[0, 1, 1, ::3] = 0.0
    cams0 = np.tile(intr, (b, c, 1))
    cams0[..., :4] += rng.normal(0, 3, (b, c, 4))
    cams0[..., 5:] = 0.0
    c0 = c_true @ np.stack([synth.euler_pose(*rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)) for _ in range(b * c)]).reshape(b, c, 4, 4)
    c0[:, 0] = np.eye(4)
    r0 = r_true @ np.stack([synth.euler_pose(*rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)) for _ in range(b * v)]).reshape(b, v, 4, 4)
    return obj, uv, mask, cams0, c0, r0, c_true


def _x0(cams0, c0, r0):
    """The Schur blocks of initial rigs: (xg (B, C*pc + 7C), view quats, view trans)."""
    b = cams0.shape[0]
    cq, ct = tblocks.poses_to_quat_tran(t64(c0))
    vq, vt = tblocks.poses_to_quat_tran(t64(r0))
    return torch.cat([t64(cams0).reshape(b, -1), cq.reshape(b, -1), ct.reshape(b, -1)], dim=-1), vq, vt


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------- SE(3), seed


def test_se3_additions_match_jax():
    rng = np.random.default_rng(0)
    k = 6
    poses = np.array(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.5, (3, k, 6)))))
    mask = (rng.uniform(size=(3, k)) > 0.3).astype(float)
    mask[1] = 0.0  # no valid pose: identity
    mask[2, 0] = 0.0  # first pose invalid: the reference pose is the next
    poses[2, 0] = np.nan  # a degenerate view is selected away, not weighted
    poses[0, 3] = poses[0, 3] @ np.diag([-1.0, -1.0, 1.0, 1.0])  # a far rotation
    q = rng.normal(size=(4, 4))
    np.testing.assert_array_equal(tse3.quat_conj(t64(q)).numpy(), np.asarray(jse3.quat_conj(jnp.asarray(q))))
    np.testing.assert_allclose(
        tse3.se3_inverse(t64(poses[0])).numpy(), np.asarray(jse3.se3_inverse(jnp.asarray(poses[0]))), atol=1e-12
    )
    want = np.asarray(jax.vmap(jse3.average_isometries)(jnp.asarray(poses), jnp.asarray(mask)))
    got = tse3.average_isometries(t64(poses), t64(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-9)
    np.testing.assert_allclose(got[1], np.eye(4), atol=1e-15)
    np.testing.assert_allclose(
        tse3.average_isometries(t64(poses[0])).numpy(), np.asarray(jse3.average_isometries(jnp.asarray(poses[0]))),
        atol=1e-9,
    )


@pytest.mark.parametrize("c", [2, 3])
def test_extrinsic_dlt_matches_jax(c):
    """One (view, camera) pair has 3 points: its planar pose is degenerate
    and both averages must leave it out, without raising."""
    obj, uv, mask, cams0, _, _, _ = rigs(3, 5, c)
    mask[1, 2, c - 1, 3:] = 0.0
    norm = np.asarray(jcm.normalize(jnp.asarray(cams0)[:, None, :, None, :5], jnp.asarray(uv)))
    np.testing.assert_allclose(
        tcm.normalize(t64(cams0)[:, None, :, None, :5], t64(uv)).numpy(), norm, atol=1e-12
    )
    want = jax.vmap(jel.estimate_extrinsic_dlt)(jnp.asarray(obj), jnp.asarray(norm), jnp.asarray(mask > 0))
    got = tel.estimate_extrinsic_dlt(t64(obj), t64(norm), torch.as_tensor(mask > 0))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-9)


# ----------------------------------------------------------------- Jacobian


def _jax_res(xg, q, t, o, u, m, c):
    return jext._view_residual(JPINHOLE, xg, q, t, o, u, m, PC, c)


@pytest.mark.parametrize("c", [2, 3])
def test_rig_jacobian_matches_jacfwd_and_jax(c):
    """The analytic Jacobian equals torch.func.jacfwd of the retracted
    per-view residual and the reference's per-camera grouped jacfwd."""
    obj, uv, mask, cams0, c0, r0, _ = rigs(2, 4, c, seed=9)
    xg, vq, vt = _x0(cams0, c0, r0)
    data = (t64(obj), t64(uv), t64(mask))
    got = text._view_residual_jac_pinhole(xg, vq, vt, *data, PC, c)

    g_man = text.global_manifold(PC, c)
    pg = g_man.tangent_dim

    def res_local(delta, xg1, q1, t1, o1, u1, m1):
        xg_n = g_man.retract(xg1, delta[:pg])
        qn = tse3.quat_mul(q1, tse3.exp_quat(delta[pg : pg + 3]))
        qn = qn / torch.linalg.norm(qn)
        return text._view_residual(xg_n[None], qn[None, None], (t1 + delta[pg + 3 :])[None, None],
                                   o1[None, None], u1[None, None], m1[None, None], PC, c)[0, 0]

    zero = torch.zeros(pg + 6, dtype=torch.float64)
    for i in range(2):
        for j in range(4):
            fwd = torch.func.jacfwd(res_local)(zero, xg[i], vq[i, j], vt[i, j], *(d[i, j] for d in data))
            want_j = jext._view_residual_jac_grouped(
                JPINHOLE, jnp.asarray(xg[i].numpy()), jnp.asarray(vq[i, j].numpy()), jnp.asarray(vt[i, j].numpy()),
                *(jnp.asarray(d[i, j].numpy()) for d in data), PC, c,
            )
            for want in (fwd.numpy(), np.asarray(want_j)):
                scale = np.maximum(1.0, np.abs(want))
                np.testing.assert_allclose(got[i, j].numpy() / scale, want / scale, rtol=0, atol=1e-10)


# ------------------------------------------------------------------ solves


@pytest.mark.parametrize("huber", [1.0, 0.0], ids=["huber", "plain_lsq"])
def test_lm_core_schur_rig_matches_jax(huber):
    """The engine alone, both sides on the analytic rig Jacobian: gauge
    masks, a manifold global block, lower bounds and Huber blocks per
    (view, camera) pair."""
    c, v = 2, 5
    obj, uv, mask, cams0, c0, r0, _ = rigs(3, v, c)
    xg0, vq, vt = _x0(cams0, c0, r0)
    free = text._free_mask(text.ExtrinsicOptions(), PC, c, v)
    ga = xg0.shape[-1]
    lower = np.full(ga, -np.inf)
    lower[[0, 1, PC, PC + 1]] = 0.0
    view_free = free[ga : ga + 4 * v : 4].astype(float)
    opts = dict(max_iterations=40, epsilon=1e-10, huber_delta=huber)
    g_man = text.global_manifold(PC, c)
    res, jac = text._residual_fns(PC, c)
    tout = tlm.lm_core_schur(
        res, jac, xg0, vq, vt, (t64(obj), t64(uv), t64(mask)), options=text.OptimOptions(**opts),
        g_free=torch.as_tensor(free[:ga]), view_valid=t64(view_free).expand(3, v), lower_g=t64(lower),
        g_manifold=g_man, blocks_per_view=c,
    )
    jg = jext.ProductManifold([jext.euclid(PC)] * c + [jext.quat()] * c + [jext.euclid(3)] * c)

    def one(o, u, m, x, q, t):
        return jlm.lm_core_schur(
            lambda *a: _jax_res(*a, c), x, q, t, (o, u, m), options=JOptimOptions(**opts),
            g_free=jnp.asarray(free[:ga]), view_valid=jnp.asarray(view_free), lower_g=jnp.asarray(lower),
            g_manifold=jg, blocks_per_view=c,
            jac_view_fn=lambda *a: jext._view_residual_jac_pinhole(*a, PC, c),
        )

    jout = jax.device_get(jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in (obj, uv, mask, xg0.numpy(), vq.numpy(), vt.numpy()))
    ))
    for name in ("iterations", "linearizations", "termination"):
        np.testing.assert_array_equal(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
    assert bool(tout.success.all()) and len(set(tout.linearizations.tolist())) > 1
    np.testing.assert_allclose(tout.cost.numpy(), jout.cost, rtol=1e-10)
    np.testing.assert_allclose(tout.xg.numpy(), jout.xg, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(tout.quats.numpy(), jout.quats, atol=1e-8)
    np.testing.assert_allclose(tout.trans.numpy(), jout.trans, atol=1e-8)
    # gauge: camera 0 and target 0 never move
    np.testing.assert_array_equal(tout.xg[:, 2 * PC : 2 * PC + 4].numpy(), xg0[:, 2 * PC : 2 * PC + 4].numpy())
    np.testing.assert_array_equal(tout.quats[:, 0].numpy(), vq[:, 0].numpy())


SOLVE_CASES = {
    "stereo_huber": dict(c=2, v=5, core=dict(max_iterations=60, epsilon=1e-10)),
    "stereo_plain_lsq": dict(c=2, v=5, core=dict(max_iterations=60, epsilon=1e-10, huber_delta=0.0)),
    "rig3_huber": dict(c=3, v=4, core=dict(max_iterations=60, epsilon=1e-10)),
    "extrinsics_only": dict(c=2, v=5, core=dict(max_iterations=60, epsilon=1e-10), optimize_intrinsics=False),
}


def _opts_pair(spec):
    jopts = JExtrinsicOptions(
        core=JOptimOptions(compute_covariance=True, **spec["core"]),
        optimize_intrinsics=spec.get("optimize_intrinsics", True),
    )
    return jopts, convert.extrinsic_options(jopts)


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_optimize_extrinsics_matches_jax(case):
    """optimize_extrinsics_device with covariance on, against the JAX
    default (Schur, per-camera grouped jacfwd) vmapped over the same rigs."""
    spec = SOLVE_CASES[case]
    obj, uv, mask, cams0, c0, r0, _ = rigs(3, spec["v"], spec["c"])
    jopts, topts = _opts_pair(spec)
    jout = jax.device_get(jax.jit(jax.vmap(
        lambda o, u, m, i, cc, rr: jext.optimize_extrinsics_device(o, u, i, cc, rr, mask=m, opts=jopts)
    ))(*(jnp.asarray(a) for a in (obj, uv, mask, cams0, c0, r0))))
    tout = text.optimize_extrinsics_device(
        t64(obj), t64(uv), t64(cams0), t64(c0), t64(r0), mask=t64(mask), opts=topts
    )
    _assert_solves_match(tout, jout)
    assert bool(tout[0].success.all())


def _assert_solves_match(tout, jout, covariance=True):
    lm_t, lm_j = tout[0], jout[0]
    for name in ("iterations", "linearizations", "termination", "success"):
        np.testing.assert_array_equal(getattr(lm_t, name).numpy(), np.asarray(getattr(lm_j, name)), err_msg=name)
    np.testing.assert_allclose(lm_t.initial_cost.numpy(), lm_j.initial_cost, rtol=1e-12)
    np.testing.assert_allclose(lm_t.cost.numpy(), lm_j.cost, rtol=1e-10)
    for g, w in zip(tout[1:4], jout[1:4]):  # cameras, c_se3_r, r_se3_t
        for i in range(g.shape[0]):
            assert _rel(g[i].numpy(), w[i]) < 1e-8
    if covariance:
        cov_t, ok_t, cov_j, ok_j = tout[4].numpy(), tout[5].numpy(), np.asarray(jout[4]), np.asarray(jout[5])
        np.testing.assert_array_equal(ok_t, ok_j)
        assert ok_t.all()
        for i in range(cov_t.shape[0]):
            assert _rel(cov_t[i], cov_j[i]) < 1e-6


@pytest.mark.parametrize("phased", [False, True], ids=["single_phase", "phased"])
def test_extrinsics_batch_matches_jax(phased):
    """extrinsics_batch against the JAX driver, with a budget (40) larger
    than cap + mid (5 + 8), so all three phases have room. B = 8 rigs with
    the phase boundaries forced; covariance off, as the phased path needs."""
    obj, uv, mask, cams0, c0, r0, _ = rigs(8, 4, 2, seed=11)
    jopts = JExtrinsicOptions(core=JOptimOptions(max_iterations=40, epsilon=1e-12, compute_covariance=False))
    jout = jax.device_get(jbatched.extrinsics_batch(obj, uv, cams0, c0, r0, mask=mask, opts=jopts, two_phase=phased))
    tout = tbatched.extrinsics_batch(
        t64(obj), t64(uv), t64(cams0), t64(c0), t64(r0), mask=t64(mask),
        opts=convert.extrinsic_options(jopts), two_phase=phased,
    )
    _assert_solves_match(tout, jout, covariance=False)
    assert not bool(tout[5].any()) and tout[4].shape == (8, 2 * PC + 14 + 28, 2 * PC + 14 + 28)
    if phased:
        # some lane ran past the first phase
        assert int(tout[0].iterations.max()) > tbatched.EXTRINSICS_PHASE_CAP


def test_stereo_smoke_set_matches_jax():
    """chip_smoke.py's config-3 stereo set (4 of its 128 rigs) on the phased
    schedule the card runs: the port equals the JAX driver, and the
    reference's own camera-1 pose error lies inside the smoke's pose bound,
    which is set from the reference (its worst rig at 128 rigs: 11.1 mm /
    1.07 deg)."""
    import chip_smoke

    p = chip_smoke.stereo_problems(4)
    keys = ("obj", "uv", "intr0", "c0", "r0")
    jopts = JExtrinsicOptions(core=JOptimOptions(max_iterations=50, compute_covariance=False))
    assert convert.extrinsic_options(jopts) == chip_smoke.STEREO_OPTS
    jout = jax.device_get(jbatched.extrinsics_batch(*(p[k] for k in keys), opts=jopts, two_phase=True))
    tout = tbatched.extrinsics_batch(*(t64(p[k]) for k in keys), opts=chip_smoke.STEREO_OPTS, two_phase=True)
    _assert_solves_match(tout, jout, covariance=False)
    assert int(tout[0].iterations.max()) > tbatched.EXTRINSICS_PHASE_CAP
    want = chip_smoke.pose_errors(np.asarray(jout[2])[:, 1], p["rel_gt"])
    got = chip_smoke.pose_errors(tout[2][:, 1].numpy(), p["rel_gt"])
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert want[0] <= chip_smoke.POSE_TOL_M and want[1] <= chip_smoke.POSE_TOL_DEG


def test_phase_schedule_keeps_the_budget():
    caps = (tbatched.EXTRINSICS_PHASE_CAP, tbatched.EXTRINSICS_PHASE_MID)
    for total, want in ((0, (0,)), (1, (1,)), (5, (5,)), (6, (5, 1)), (13, (5, 8)), (14, (5, 8, 1)),
                        (50, (5, 8, 37))):
        assert tbatched._phase_budget(total, caps) == want
        assert sum(want) == total


def test_optimize_extrinsics_host_wrapper_matches_jax():
    obj, uv, mask, cams0, c0, r0, _ = rigs(1, 5, 2, seed=4)
    jopts, topts = _opts_pair(SOLVE_CASES["stereo_huber"])
    want = jext.optimize_extrinsics(obj[0], uv[0], cams0[0], c0[0], r0[0], mask=mask[0], opts=jopts)
    got = text.optimize_extrinsics(
        t64(obj[0]), t64(uv[0]), t64(cams0[0]), t64(c0[0]), t64(r0[0]), mask=t64(mask[0]), opts=topts
    )
    assert got.core.report == want.core.report
    assert (got.core.success, got.core.iterations, got.core.termination) == (
        want.core.success, want.core.iterations, want.core.termination,
    )
    for name in ("cameras", "c_se3_r", "r_se3_t"):
        assert _rel(getattr(got, name), getattr(want, name)) < 1e-8
    assert _rel(got.core.covariance, want.core.covariance) < 1e-6
    np.testing.assert_array_equal(got.c_se3_r[0], np.eye(4))  # gauge
    with pytest.raises(ValueError, match="Incompatible"):
        text.optimize_extrinsics(t64(obj[0]), t64(uv[0]), t64(cams0[0, :1]), t64(c0[0]), t64(r0[0]))


def test_unported_paths_raise():
    """A mesh that is not the port's is refused (the port's mesh is
    tests/test_torch_sharding.py; every registry model is taken: the
    Scheimpflug solves are tests/test_torch_scheimpflug_solvers.py); a
    model outside the registry and an unknown solver name are errors (the
    dense solver is ported: test_torch_lm_dense.py)."""
    obj, uv, mask, cams0, c0, r0, _ = rigs(1, 4, 2)
    args = (t64(obj), t64(uv), t64(cams0), t64(c0), t64(r0))
    with pytest.raises(TypeError, match="make_mesh"):
        tbatched.extrinsics_batch(*args, mesh=object())
    with pytest.raises(KeyError, match="Unknown camera model"):
        tbatched.extrinsics_batch(*args, model_name="fisheye")
    with pytest.raises(ValueError, match="unknown solver"):
        text.optimize_extrinsics_device(*args, solver="qr")


def test_extrinsic_options_convert_field_for_field():
    assert [f.name for f in dataclasses.fields(text.ExtrinsicOptions)] == [
        f.name for f in dataclasses.fields(JExtrinsicOptions)
    ]
    jopts = JExtrinsicOptions(core=JOptimOptions(max_iterations=7, huber_delta=0.5), optimize_skew=True)
    got = convert.extrinsic_options(jopts)
    assert dataclasses.asdict(got) == dataclasses.asdict(jopts) | {"core": dataclasses.asdict(got.core)}
    assert got.core.max_iterations == 7 and got.core.huber_delta == 0.5 and got.optimize_skew
