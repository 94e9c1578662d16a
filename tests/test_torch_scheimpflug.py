"""Port equivalence of the Scheimpflug camera and the model-generic
intrinsics solvers (``calibration_tpu_torch/models/{distortion, pinhole,
scheimpflug, registry}.py``, ``optim/lm_schur.view_jacobian_fn``,
``optim/intrinsics.py``, ``parallel/batched.intrinsics_batch`` /
``intrinsics_facade_batch`` and the intrinsics facade) against the JAX
package, CPU, float64.

Data: 3 cameras x 5 views of a 5x6 grid at 0.04 m seen through a tilted
sensor (tau = (0.05, -0.04), radial-only base distortion) with 0.2 px
noise, the reference's own Scheimpflug configuration; the facade sees two
such cameras x 8 views at 0.05 px. JAX compiles two programs here (the
phased intrinsics_batch and the facade's fleet solve, whose recorded call
is the single-phase case), as each compile costs tens of seconds on a CPU.

Bars: the model functions within 1e-12 (zero tilt equals pinhole); the
forward-mode per-view Jacobian within 1e-10 of the analytic pinhole one and
of JAX's jacfwd; the solves with equal iterations, linearizations and
termination, final cost within 1e-10 relative and covariance within 1e-8
of its largest entry, with the distortion indices fixed and free; the
facade's report through ``torch_helpers.assert_reports_match``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synth
from calibration_tpu.io import jsonio as jjsonio
from calibration_tpu.models import distortion as jdist
from calibration_tpu.models import pinhole as jpin
from calibration_tpu.models import registry as jreg
from calibration_tpu.models import scheimpflug as jsch
from calibration_tpu.ops import se3 as jse3
from calibration_tpu.optim import IntrinsicsOptimOptions as JOpts
from calibration_tpu.optim import OptimOptions as JCore
from calibration_tpu.optim import intrinsics as joi
from calibration_tpu.parallel import batched as jbatched
from calibration_tpu.pipeline.dataset import PlanarDetections as JDetections
from calibration_tpu.pipeline.facades import intrinsics as jf
from calibration_tpu.pipeline.reports import build_camera_report as jreport
from calibration_tpu_torch.io import jsonio as tjsonio
from calibration_tpu_torch.models import distortion as tdist
from calibration_tpu_torch.models import pinhole as tpin
from calibration_tpu_torch.models import registry as treg
from calibration_tpu_torch.models import scheimpflug as tsch
from calibration_tpu_torch.ops import projection_residuals as pr
from calibration_tpu_torch.optim import IntrinsicsOptimOptions as TOpts
from calibration_tpu_torch.optim import OptimOptions as TCore
from calibration_tpu_torch.optim import intrinsics as toi
from calibration_tpu_torch.optim import lm_schur as tlm
from calibration_tpu_torch.parallel import batched as tbatched
from calibration_tpu_torch.pipeline.dataset import PlanarDetections as TDetections
from calibration_tpu_torch.pipeline.facades import intrinsics as tf
from calibration_tpu_torch.pipeline.reports import build_camera_report as treport
from chip_smoke import detections_payload
from torch_helpers import assert_reports_match, k1_launches, one_torch_thread, t64  # noqa: F401

B, V = 3, 5
TILT = (0.05, -0.04)
SCHEIM = jreg.SCHEIMPFLUG.name


def scheimpflug_camera(tilt=TILT):
    intr = synth.default_camera()
    intr[8:] = 0.0  # radial-only base distortion
    return np.concatenate([intr, tilt])


def scheimpflug_views(b=B, v=V, noise=0.2, seed=3):
    """(obj (B, V, N, 2), uv (B, V, N, 2), poses (B, V, 4, 4), camera (12,))
    through the JAX Scheimpflug model."""
    rng = np.random.default_rng(seed)
    intr12 = scheimpflug_camera()
    obj = synth.make_target_grid(5, 6, 0.04)
    obj3 = jnp.concatenate([jnp.asarray(obj), jnp.zeros((obj.shape[0], 1))], -1)
    poses = np.stack([synth.circle_views(v, tilt=0.25 + 0.03 * i) for i in range(b)])
    pc = jse3.se3_apply(jnp.asarray(poses)[:, :, None], obj3)
    uv = np.asarray(jsch.project(jnp.asarray(intr12), pc)) + rng.normal(0, noise, poses.shape[:2] + obj.shape)
    return np.broadcast_to(obj, (b, v) + obj.shape).copy(), uv, poses, intr12


def _points(seed=0, n=40):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-0.4, 0.4, (n, 2)), rng.uniform(0.6, 1.8, (n, 1))], -1)
    return xyz, rng.uniform(40, 600, (n, 2))


MODEL_CASES = {
    "undistort": lambda j, t: (
        jdist.undistort(jnp.asarray(j[1][:, :2] / 900.0), jnp.asarray(j[0][5:10])),
        tdist.undistort(t64(j[1][:, :2] / 900.0), t64(j[0][5:10])),
    ),
    "pinhole_unproject": lambda j, t: (jpin.unproject(jnp.asarray(j[0][:10]), jnp.asarray(j[1])),
                                       tpin.unproject(t64(j[0][:10]), t64(j[1]))),
    "scheimpflug_project": lambda j, t: (jsch.project(jnp.asarray(j[0]), jnp.asarray(j[2])),
                                         tsch.project(t64(j[0]), t64(j[2]))),
    "scheimpflug_unproject": lambda j, t: (jsch.unproject(jnp.asarray(j[0]), jnp.asarray(j[1])),
                                           tsch.unproject(t64(j[0]), t64(j[1]))),
    "scheimpflug_unproject_normalized": lambda j, t: (
        jsch.unproject_normalized(jnp.asarray(j[0]), jnp.asarray(j[1])),
        tsch.unproject_normalized(t64(j[0]), t64(j[1])),
    ),
    "zero_tilt_is_pinhole": lambda j, t: (jpin.project(jnp.asarray(j[0][:10]), jnp.asarray(j[2])),
                                          tsch.project(t64(np.concatenate([j[0][:10], [0.0, 0.0]])), t64(j[2]))),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_functions_match_jax(case):
    xyz, uv = _points()
    intr12 = scheimpflug_camera((0.08, -0.05))
    intr12[8:10] = [1e-4, -2e-4]  # tangential terms too
    want, got = MODEL_CASES[case]((intr12, uv, xyz), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12 * max(1.0, np.abs(want).max()))


def test_registry_matches_jax():
    # the reference's fields in its order, then the port's own
    fields = [f.name for f in dataclasses.fields(jreg.CameraModelSpec)] + ["qa_recheck"]
    assert [f.name for f in dataclasses.fields(treg.CameraModelSpec)] == fields
    assert [m.name for m in treg.SPECS if m.qa_recheck] == [treg.PINHOLE.name]
    assert sorted(treg.MODELS) == sorted(jreg.MODELS)
    for name, jspec in jreg.MODELS.items():
        tspec = treg.get_model(name)
        for f in ("name", "param_count", "idx_fx", "idx_fy", "idx_skew", "idx_dist0"):
            assert getattr(tspec, f) == getattr(jspec, f), (name, f)
    with pytest.raises(KeyError, match="Unknown camera model"):
        treg.get_model("fisheye")
    # pack: the app's camera from K, coefficients and tilt
    k, coeffs = np.array([600.0, 610.0, 320.0, 240.0, 0.0]), np.array([-0.1, 0.03, 1e-4, -5e-5])
    want = jsch.pack(jpin.pack(jnp.asarray(k), jnp.asarray(coeffs)), 0.06, -0.04)
    np.testing.assert_array_equal(tsch.pack(tpin.pack(k, coeffs), 0.06, -0.04).numpy(), np.asarray(want))


def _state(model_pc=12, seed=7):
    """A perturbed state (intr (B, pc), quats, trans) near the data's truth."""
    obj, uv, poses, intr12 = scheimpflug_views()
    rng = np.random.default_rng(seed)
    intr = np.tile(intr12[:model_pc], (B, 1))
    intr[:, :4] += rng.normal(0, 3, (B, 4))
    quats = np.asarray(jse3.rotmat_to_quat(jnp.asarray(poses[..., :3, :3])))
    trans = poses[..., :3, 3] + rng.normal(0, 0.01, (B, V, 3))
    mask = np.ones(obj.shape[:-1])
    mask[0, 1, ::3] = 0.0
    return intr, quats, trans, obj, uv, mask


def test_forward_jacobian_matches_the_analytic_pinhole_one():
    args = [t64(a) for a in _state(10)]
    want = toi._view_residual_jac_pinhole(*args)
    got = tlm.view_jacobian_fn(toi._view_residual)(*args)
    assert got.shape == want.shape == (B, V, 60, 16)
    scale = want.abs().clamp(min=1.0)
    assert float(((got - want) / scale).abs().max()) <= 1e-10


def test_forward_jacobian_matches_jax_jacfwd_scheimpflug():
    intr, quats, trans, obj, uv, mask = _state()
    got = tlm.view_jacobian_fn(lambda *a: toi._view_residual(*a, model=treg.SCHEIMPFLUG))(
        *(t64(a) for a in (intr, quats, trans, obj, uv, mask))
    ).numpy()
    pg = 12

    def local(delta, xg, q, t, o, u, m):
        qn = jse3.quat_mul(q, jse3.exp_quat(delta[pg : pg + 3]))
        qn = qn / jnp.linalg.norm(qn)
        return joi._view_residual(jreg.SCHEIMPFLUG, xg + delta[:pg], qn, t + delta[pg + 3 :], o, u, m)

    per_view = jax.vmap(jax.jacfwd(local), in_axes=(None, None, 0, 0, 0, 0, 0))
    want = jax.jit(jax.vmap(per_view, in_axes=(None, 0, 0, 0, 0, 0, 0)))(
        jnp.zeros(pg + 6), *(jnp.asarray(a) for a in (intr, quats, trans, obj, uv, mask))
    )
    scale = np.maximum(1.0, np.abs(np.asarray(want)))
    np.testing.assert_allclose(got / scale, np.asarray(want) / scale, rtol=0, atol=1e-10)


def _assert_solves_match(tout, jout, cov=True):
    for name in ("iterations", "linearizations", "termination", "success"):
        np.testing.assert_array_equal(getattr(tout[0], name).numpy(), np.asarray(getattr(jout[0], name)), err_msg=name)
    np.testing.assert_allclose(tout[0].cost.numpy(), np.asarray(jout[0].cost), rtol=1e-10)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), rtol=0, atol=1e-8)
    if cov:
        np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
        want = np.asarray(jout[4])
        scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
        assert np.all(np.abs(tout[4].numpy() - want) <= 1e-8 * scale)


BATCH_CASES = {
    # p1 and p2 pinned (the 2S / 2T configuration), phased: intrinsics_batch
    "fixed_phased": (dict(fixed_distortion_indices=(2, 3)), False, True),
    # every coefficient free, one phase, covariance on: the
    # intrinsics_facade_batch call the intrinsics facade makes
    "free_single_covariance": (dict(), True, False),
}


def _facade_payloads():
    obj, uv, _, _ = scheimpflug_views(b=2, v=8, noise=0.05, seed=11)
    return {f"tilted{i}": detections_payload(f"tilted{i}", obj[i, 0], uv[i]) for i in range(2)}


def _facade_config(model):
    return {
        "algorithm": "planar",
        "options": {"optim_options": {"core": {"max_iterations": 60, "compute_covariance": True}},
                    "min_corners_per_view": 10},
        "cameras": [{"camera_id": f"tilted{i}", "model": model, "image_size": [640, 480]} for i in range(2)],
    }


def _run_facade(pkg, jsonio, det_cls, facade, build, batched_mod, monkeypatch):
    """calibrate_many of both cameras, recording the fleet call it makes:
    (cfg, jobs, outputs, reports, (args, kwargs, result) of its
    ``intrinsics_facade_batch``)."""
    calls = []
    inner = getattr(batched_mod, "intrinsics_facade_batch")

    def recorded(*args, **kwargs):
        calls.append((args, kwargs, inner(*args, **kwargs)))
        return calls[-1][2]

    monkeypatch.setattr(batched_mod, "intrinsics_facade_batch", recorded)
    cfg = jsonio.from_jsonable(_facade_config("scheimpflug"), pkg.IntrinsicCalibrationConfig)
    payloads = _facade_payloads()
    jobs = [(cam, jsonio.from_jsonable(payloads[cam.camera_id], det_cls)) for cam in cfg.cameras]
    outs = facade.calibrate_many(cfg, jobs)
    monkeypatch.undo()
    assert all(not isinstance(o, Exception) for o in outs), outs
    assert len(calls) == 1
    reports = [jsonio.to_jsonable(build(cam, det, o)) for (cam, det), o in zip(jobs, outs)]
    return cfg, jobs, outs, reports, calls[0]


@pytest.fixture(scope="module")
def batch_runs():
    """JAX's and the port's solves, one JAX compile each: the phased
    intrinsics_batch on the 3-camera set, and the intrinsics facade on two
    tilted cameras, whose single fleet call is the single-phase case."""
    obj, uv, _, _ = scheimpflug_views()
    extra = BATCH_CASES["fixed_phased"][0]
    jopts = JOpts(core=JCore(max_iterations=60, compute_covariance=False), **extra)
    topts = TOpts(core=TCore(max_iterations=60, compute_covariance=False), **extra)
    jout = jax.device_get(jbatched.intrinsics_batch(obj, uv, opts=jopts, model_name=SCHEIM, two_phase=True))
    # the port's Scheimpflug caps are the card's; here the reference's
    saved = tbatched.SCHEIMPFLUG_PHASE_CAP_FIXED
    tbatched.SCHEIMPFLUG_PHASE_CAP_FIXED = jbatched.phase_schedule(SCHEIM, B, jopts)[0][0]
    try:
        tout = tbatched.intrinsics_batch(t64(obj), t64(uv), opts=topts, model_name="scheimpflug", two_phase=True)
    finally:
        tbatched.SCHEIMPFLUG_PHASE_CAP_FIXED = saved
    mp = pytest.MonkeyPatch()
    jax_facade = _run_facade(jf, jjsonio, JDetections, jf.PlanarIntrinsicCalibrationFacade(), jreport, jbatched, mp)
    port_facade = _run_facade(tf, tjsonio, TDetections, tf.PlanarIntrinsicCalibrationFacade("cpu"), treport, tf, mp)
    (jargs, jkw, (jseed, _, jrefine, _)), (targs, tkw, (tseed, _, trefine, _)) = jax_facade[4], port_facade[4]
    for a, b in zip(jargs + (jkw["mask"], jkw["view_valid"]), targs + (tkw["mask"], tkw["view_valid"])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))  # the same fleet inputs
    return {
        "fixed_phased": ((jout[0], jout[1]), (tout[0], tout[1])),
        "free_single_covariance": (jax.device_get((jseed, jrefine)), (tseed, trefine)),
        "facade": (jax_facade, port_facade),
    }


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_intrinsics_batch_matches_jax(batch_runs, case):
    (jseed, jout), (tseed, tout) = batch_runs[case]
    np.testing.assert_allclose(tseed.kmtx.numpy(), np.asarray(jseed.kmtx), rtol=1e-9)
    _assert_solves_match(tout, jout, cov=BATCH_CASES[case][1])
    assert tout[1].shape[-1] == 12 and bool(tout[0].success.all())
    if BATCH_CASES[case][2]:
        assert int(tout[0].linearizations.max()) > 0


def test_optimize_intrinsics_device_lanes_are_the_batch():
    """optimize_intrinsics_device with the Scheimpflug spec, the JAX spec or
    its name, from the seed a single-phase intrinsics_batch used: that
    batch's lanes, counters exactly."""
    obj, uv, _, _ = scheimpflug_views()
    opts = TOpts(core=TCore(max_iterations=60, compute_covariance=True))
    tseed, tout = tbatched.intrinsics_batch(t64(obj), t64(uv), opts=opts, model_name="scheimpflug",
                                            two_phase=False)
    init = torch.cat([tseed.kmtx, torch.zeros(B, 7, dtype=torch.float64)], dim=-1)
    init[:, 4] = 0.0  # frozen skew starts at zero, as in intrinsics_batch
    for model in (treg.SCHEIMPFLUG, jreg.SCHEIMPFLUG, "scheimpflug"):
        got = toi.optimize_intrinsics_device(t64(obj), t64(uv), init, tseed.c_se3_t, model=model, opts=opts)
        assert torch.equal(got[0].iterations, tout[0].iterations)
        np.testing.assert_allclose(got[0].cost.numpy(), tout[0].cost.numpy(), rtol=1e-13)
        np.testing.assert_allclose(got[4].numpy(), tout[4].numpy(), rtol=1e-12, atol=1e-9)


def test_facade_batch_has_no_qa_recheck_for_scheimpflug():
    """intrinsics_facade_batch solves Scheimpflug lanes, returns a zero
    rms_check and launches no kernel (the QA recheck is pinhole's)."""
    obj, uv, _, _ = scheimpflug_views()
    opts = TOpts(core=TCore(max_iterations=60, compute_covariance=False), fixed_distortion_indices=(2, 3))
    before = k1_launches()
    _, _, out, rms = tbatched.intrinsics_facade_batch(t64(obj), t64(uv), opts=opts, model_name=SCHEIM,
                                                      two_phase=False)
    assert k1_launches() == before
    assert rms.dtype == torch.float32 and rms.shape == (B, V) and not bool(rms.any())
    assert bool(out[0].success.all()) and out[1].shape == (B, 12)


def test_intrinsics_facade_scheimpflug_matches_jax(batch_runs):
    """CameraConfig.model "scheimpflug" dispatches through the registry:
    12-parameter cameras whose calibrate_many reports equal JAX's, and the
    serial calibrate gives the fleet's camera."""
    jax_facade, (port_cfg, port_jobs, port_outs, port_reports, _) = batch_runs["facade"]
    assert_reports_match(jax_facade[3], port_reports)
    for o in port_outs:
        assert o.camera.shape == (12,) and o.refine_result.core.success
        assert o.rms_check_warnings == 0 and o.view_rms_check.size == 0
    serial = tf.PlanarIntrinsicCalibrationFacade("cpu").calibrate(port_cfg, *port_jobs[0])
    np.testing.assert_allclose(serial.camera, port_outs[0].camera, rtol=1e-9)
