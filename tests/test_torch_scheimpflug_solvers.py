"""Port equivalence of the extrinsics and bundle solvers for a camera model
other than pinhole (the Scheimpflug camera): ``optim/extrinsics.py`` with
each Schur ``jac_mode`` and ``solver="dense"``, ``extrinsics_batch
(model_name=...)``, and ``optim/bundle.py`` (forward-mode Jacobians),
against the JAX package, CPU, float64.

Data: 2 two-camera rigs x 4 views of a 4x5 grid at 0.05 m, and 2 robot
cells x 8 observations of a 4x5 grid at 0.04 m (the reference's
Scheimpflug hand-eye setup, intrinsics fixed), through the camera
tau = (0.06, -0.04), zero tangential distortion, with 0.2 px noise. JAX
compiles four programs here, each jitted for one lane once per module, as
a CPU compile of a Scheimpflug LM costs seconds.

Bars: equal iterations, linearizations and termination per lane, final
cost within 1e-10 relative, poses within 1e-7, cameras within 1e-6
relative (a flat radial valley with the intrinsics free), covariance
within 1e-8 of its largest entry (1e-6 for the ill-conditioned rig
covariance, as for the pinhole rigs); the grouped, full and dense forward-mode
Jacobians equal within 1e-10 (relative to max(1, |entry|)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth
from calibration_tpu.models import pinhole as jpin
from calibration_tpu.models import scheimpflug as jsch
from calibration_tpu.models.registry import SCHEIMPFLUG as JSCHEIM
from calibration_tpu.ops import se3 as jse3
from calibration_tpu.optim import BundleOptions as JBundleOptions
from calibration_tpu.optim import ExtrinsicOptions as JExtrinsicOptions
from calibration_tpu.optim import OptimOptions as JCore
from calibration_tpu.optim import bundle as jbundle
from calibration_tpu.optim import extrinsics as jext
from calibration_tpu_torch.models.registry import SCHEIMPFLUG
from calibration_tpu_torch.optim import BundleOptions, ExtrinsicOptions, OptimOptions
from calibration_tpu_torch.optim import blocks as tblocks
from calibration_tpu_torch.optim import bundle as tbundle
from calibration_tpu_torch.optim import extrinsics as text
from calibration_tpu_torch.optim import lm as tlm
from calibration_tpu_torch.parallel import batched as tbatched
from torch_helpers import one_torch_thread, t64  # noqa: F401

B, V, C = 2, 4, 2
PC = SCHEIMPFLUG.param_count
TILT = (0.06, -0.04)


def scheimpflug_camera():
    intr10 = jpin.pack(jnp.asarray([600.0, 610.0, 320.0, 240.0, 0.0]), jnp.asarray([-0.1, 0.03, 0.0, 0.0, 0.0]))
    return np.asarray(jsch.pack(intr10, *TILT))


def render(intr, poses, obj, rng, noise=0.2):
    """Pixels (..., N, 2) of grid obj (N, 2) under poses (..., 4, 4)."""
    obj3 = jnp.concatenate([jnp.asarray(obj), jnp.zeros((obj.shape[0], 1))], -1)
    uv = np.asarray(jsch.project(jnp.asarray(intr), jse3.se3_apply(jnp.asarray(poses)[..., None, :, :], obj3)))
    return uv + rng.normal(0, noise, uv.shape)


def stereo_rigs(seed=5):
    """(obj (B, V, C, N, 2), uv, cams0 (B, C, 12), c0 (B, C, 4, 4), r0
    (B, V, 4, 4)): camera 1 offset per rig, views on a circle, perturbed
    inits."""
    rng = np.random.default_rng(seed)
    intr = scheimpflug_camera()
    obj = synth.make_target_grid(4, 5, 0.05)
    uv = np.zeros((B, V, C, obj.shape[0], 2))
    c0, r0 = np.zeros((B, C, 4, 4)), np.zeros((B, V, 4, 4))
    for i in range(B):
        rel = synth.euler_pose(0.02, -0.3 - 0.02 * i, 0.01, [-0.2, 0.01 * i, 0.02])
        rts = synth.circle_views(V, dist=1.0, tilt=0.25 + 0.03 * i)
        uv[i, :, 0] = render(intr, rts, obj, rng)
        uv[i, :, 1] = render(intr, rel[None] @ rts, obj, rng)
        c0[i] = np.stack([np.eye(4), rel @ synth.euler_pose(0.004, -0.003, 0.002, [0.003, -0.002, 0.001])])
        r0[i] = rts @ synth.euler_pose(0.003, 0.002, -0.002, [0.002, 0.001, -0.002])
    cams0 = np.tile(intr, (B, C, 1))
    cams0[..., :4] += rng.normal(0, 1, (B, C, 4))
    return np.broadcast_to(obj, uv.shape).copy(), uv, cams0, c0, r0


EXTR_CASES = {
    # (solver, jac_mode, covariance, optimize_intrinsics, how the port
    # names the model); the cases with the intrinsics fixed converge in a
    # few iterations, which keeps the file's time down
    "schur_grouped": ("schur", "grouped", False, True, "port spec"),
    "schur_full": ("schur", "full", False, False, "name"),
    "dense": ("dense", "grouped", True, False, "reference spec"),
}
MODEL_AS = {"port spec": SCHEIMPFLUG, "name": "scheimpflug", "reference spec": JSCHEIM}


def _jax_lanes(fn, args):
    """fn jitted for one lane (a vmapped compile costs about twice as
    much), run on each lane of the numpy args, stacked."""
    jfn = jax.jit(fn)
    lanes = [jax.device_get(jfn(*(jnp.asarray(a[i]) for a in args))) for i in range(args[0].shape[0])]
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *lanes)


def _extr_opts(cls, core_cls, cov, intrinsics=True):
    return cls(core=core_cls(max_iterations=40, compute_covariance=cov), optimize_intrinsics=intrinsics)


@pytest.fixture(scope="module")
def extrinsics_runs():
    """JAX's and the port's solves of the rigs, per case."""
    args = stereo_rigs()
    runs = {}
    for case, (solver, jac_mode, cov, intrinsics, model_as) in EXTR_CASES.items():
        jopts = _extr_opts(JExtrinsicOptions, JCore, cov, intrinsics)

        def one(o, u, i0, c0, r0, solver=solver, jac_mode=jac_mode, jopts=jopts):
            return jext.optimize_extrinsics_device(o, u, i0, c0, r0, model=JSCHEIM, opts=jopts, solver=solver,
                                                   jac_mode=jac_mode)

        jout = _jax_lanes(one, args)
        tout = text.optimize_extrinsics_device(*(t64(a) for a in args), model=MODEL_AS[model_as],
                                               opts=_extr_opts(ExtrinsicOptions, OptimOptions, cov, intrinsics),
                                               solver=solver,
                                               jac_mode=jac_mode)
        runs[case] = (jout, tout)
    return runs


def _assert_solves_match(tout, jout, cov=None):
    """Counters, costs and solution of B lanes; the covariance within
    ``cov`` of its largest entry, when given."""
    for name in ("iterations", "linearizations", "termination", "success"):
        np.testing.assert_array_equal(getattr(tout[0], name).numpy(), np.asarray(getattr(jout[0], name)), err_msg=name)
    assert bool(tout[0].success.all())
    np.testing.assert_allclose(tout[0].cost.numpy(), np.asarray(jout[0].cost), rtol=1e-10)
    np.testing.assert_allclose(tout[0].initial_cost.numpy(), np.asarray(jout[0].initial_cost), rtol=1e-10)
    # with the intrinsics free on 4 views the radial terms sit in a flat
    # valley (k3 ~ -1e2): the cameras to 1e-6 relative, the poses to 1e-7
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=1e-6, atol=1e-8)
    for t, j in zip(tout[2:4], jout[2:4]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-7)
    if cov is not None:
        np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
        want = np.asarray(jout[4])
        scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
        assert np.all(np.abs(tout[4].numpy() - want) <= cov * scale)


@pytest.mark.parametrize("case", sorted(EXTR_CASES))
def test_extrinsics_scheimpflug_matches_jax(extrinsics_runs, case):
    jout, tout = extrinsics_runs[case]
    # the rig covariance is ill-conditioned (4 views, the tilt free): 1e-6,
    # as for the pinhole rigs (tests/test_torch_extrinsics.py)
    _assert_solves_match(tout, jout, 1e-6 if EXTR_CASES[case][2] else None)
    assert tout[1].shape == (B, C, PC)


def _state(seed=9):
    """A perturbed (xg (B, ga), quats (B, V, 4), trans (B, V, 3), view data)
    near the rigs' inits."""
    obj, uv, cams0, c0, r0 = stereo_rigs()
    cq, ct = tblocks.poses_to_quat_tran(t64(c0))
    vq, vt = tblocks.poses_to_quat_tran(t64(r0))
    xg = torch.cat([t64(cams0).reshape(B, -1), cq.reshape(B, -1), ct.reshape(B, -1)], dim=-1)
    xg = xg + 1e-3 * torch.as_tensor(np.random.default_rng(seed).normal(size=xg.shape))
    mask = torch.ones(obj.shape[:-1], dtype=torch.float64)
    mask[0, 1, 1, ::3] = 0.0
    return xg, vq, vt, (t64(obj), t64(uv), mask)


def test_grouped_full_and_dense_jacobians_agree():
    xg, vq, vt, data = _state()
    res_g, jac_g = text._residual_fns(PC, C, SCHEIMPFLUG, "grouped")
    res_f, jac_f = text._residual_fns(PC, C, SCHEIMPFLUG, "full")
    grouped = jac_g(xg, vq, vt, *data)
    full = jac_f(xg, vq, vt, *data)
    ga_t = C * PC + 6 * C
    assert grouped.shape == full.shape == (B, V, C * 20 * 2, ga_t + 6)
    scale = full.abs().clamp(min=1.0)
    assert float(((grouped - full) / scale).abs().max()) <= 1e-10
    # the dense solver's Jacobian: rows (view, camera, point, u/v), columns
    # [global | view rotations (3V) | view translations (3V)]
    x = torch.cat([xg, vq.reshape(B, -1), vt.reshape(B, -1)], dim=-1)
    _, dense = tlm.tangent_jacobian(lambda xx, *d: text._residual_flat(xx, *d, SCHEIMPFLUG),
                                    text.make_manifold(PC, C, V), x, data)
    dense = dense.reshape(B, V, -1, dense.shape[-1])
    for v in range(V):
        cols = list(range(ga_t)) + [ga_t + 3 * v + k for k in range(3)] + [ga_t + 3 * V + 3 * v + k for k in range(3)]
        assert float(((dense[:, v][..., cols] - full[:, v]) / scale[:, v]).abs().max()) <= 1e-10


def test_extrinsics_batch_takes_the_model(extrinsics_runs):
    """extrinsics_batch(model_name="scheimpflug"): one phase is the
    grouped optimize_extrinsics_device solve to the bit (and so JAX's); the
    phased schedule converges every rig to the same cost."""
    args = [t64(a) for a in stereo_rigs()]
    opts = _extr_opts(ExtrinsicOptions, OptimOptions, False)
    direct = extrinsics_runs["schur_grouped"][1]
    single = tbatched.extrinsics_batch(*args, opts=opts, model_name=JSCHEIM.name, two_phase=False)
    for got, want in zip(single, direct):
        for g, w in zip(got, want) if isinstance(got, tuple) else ((got, want),):
            assert torch.equal(g, w)
    phased = tbatched.extrinsics_batch(*args, opts=opts, model_name="scheimpflug", two_phase=True)
    n = C * PC + 7 * C + 7 * V
    assert bool(phased[0].success.all()) and phased[4].shape == (B, n, n)
    np.testing.assert_allclose(phased[0].cost.numpy(), single[0].cost.numpy(), rtol=1e-6)


def handeye_cells(seed=11, num_obs=8):
    """(obj (B, O, N, 2), uv, b_se3_g (B, O, 4, 4), cam_idx (B, O), intr
    (B, 1, 12), g0 (B, 1, 4, 4), b0 (B, 4, 4), g truth (B, 4, 4)): the
    reference's Scheimpflug hand-eye sequence per cell, perturbed seeds."""
    rng = np.random.default_rng(seed)
    intr = scheimpflug_camera()
    obj = synth.make_target_grid(4, 5, 0.04)
    out = {k: [] for k in ("uv", "bg", "g0", "b0", "g")}
    for _ in range(B):
        sim = synth.make_handeye_sequence(num_poses=num_obs, rng=rng)
        out["uv"].append(render(intr, sim["c_se3_t"], obj, rng))
        out["bg"].append(sim["b_se3_g"])
        out["g0"].append(sim["g_se3_c"] @ synth.euler_pose(0.01, -0.01, 0.01, [0.001, -0.001, 0.001]))
        out["b0"].append(sim["b_se3_t"] @ synth.euler_pose(0.005, -0.005, 0.005, [0.005, 0.005, -0.005]))
        out["g"].append(sim["g_se3_c"])
    uv = np.stack(out["uv"])
    return (np.broadcast_to(obj, uv.shape).copy(), uv, np.stack(out["bg"]), np.zeros((B, num_obs), np.int64),
            np.tile(intr, (B, 1, 1)), np.stack(out["g0"])[:, None], np.stack(out["b0"]), np.stack(out["g"]))


@pytest.fixture(scope="module")
def bundle_runs():
    args = handeye_cells()
    jopts = JBundleOptions(core=JCore(max_iterations=40))

    def one(o, u, bg, ci, i0, g0, b0):
        return jbundle.optimize_bundle_device(o, u, bg, ci, i0, g0, b0, model=JSCHEIM, opts=jopts)

    jout = _jax_lanes(one, args[:7])
    tin = [t64(a) if a.dtype != np.int64 else torch.as_tensor(a) for a in args[:7]]
    tout = tbundle.optimize_bundle_device(*tin, model="scheimpflug", opts=BundleOptions(core=OptimOptions(max_iterations=40)))
    return args, jout, tout


def test_bundle_scheimpflug_matches_jax(bundle_runs):
    args, jout, tout = bundle_runs
    _assert_solves_match(tout, jout, 1e-8)
    np.testing.assert_array_equal(tout[1].numpy(), args[4])  # intrinsics fixed
    assert max(synth.rot_err_deg(g, t) for g, t in zip(tout[2][:, 0].numpy(), args[7])) < 0.5


def test_optimize_bundle_scheimpflug_is_a_lane(bundle_runs):
    """The host wrapper with the model gives lane 1 of the device batch;
    ``analytic_jac`` has no effect for a model without an analytic
    Jacobian."""
    args, _, tout = bundle_runs
    lane = [t64(a[1]) if a.dtype != np.int64 else torch.as_tensor(a[1]) for a in args[:7]]
    for analytic in (True, False):
        res = tbundle.optimize_bundle(*lane, model=SCHEIMPFLUG, opts=BundleOptions(core=OptimOptions(max_iterations=40)),
                                      analytic_jac=analytic)
        assert res.core.iterations == int(tout[0].iterations[1]) and res.cameras.shape == (1, PC)
        np.testing.assert_allclose(res.core.final_cost, float(tout[0].cost[1]), rtol=1e-12)
        np.testing.assert_allclose(res.g_se3_c, tout[2][1].numpy(), rtol=0, atol=1e-12)
