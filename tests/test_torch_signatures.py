"""The port's public solver and batch functions take their JAX twins'
parameters, by name and in order, so a call written for the reference
binds every argument to the same parameter in the port. Parameters only
the port has come after the reference's and are keyword-only. A value the
port does not honour (a camera model a path does not take, an unknown
``jac_mode``) raises ``NotImplementedError`` ("not ported yet") before any
work. The intrinsics, line-scan, extrinsics and bundle solvers take every
registry model; bundle_batch takes the pinhole model only, as the
reference's. Every batch entry point takes a port mesh
(``parallel.make_mesh``) and refuses a JAX one; the intrinsics solvers take
"mixed" and "mixed_jac", the bundle solver "mixed".

The port's ``*_device`` functions keep a leading batch axis where the
reference's take one problem: only names and order are compared."""

import inspect

import jax
import numpy as np
import pytest
import torch

from calibration_tpu.models import camera_matrix as jcm
from calibration_tpu.models import distortion as jdist
from calibration_tpu.models import pinhole as jpin
from calibration_tpu.models import scheimpflug as jsch
from calibration_tpu.models.registry import SCHEIMPFLUG
from calibration_tpu.ops import intrinsics_linear as jlin
from calibration_tpu.ops import linalg as jlinalg
from calibration_tpu.ops import linescan as jls
from calibration_tpu.ops import planarpose as jplanar
from calibration_tpu.ops import planefit as jpf
from calibration_tpu.ops import ransac as jransac
from calibration_tpu.ops import se3 as jse3
from calibration_tpu.optim import bundle as jbundle
from calibration_tpu.optim import extrinsics as jext
from calibration_tpu.optim import handeye as jhe
from calibration_tpu.optim import homography as jhom
from calibration_tpu.optim import intrinsics as jintr
from calibration_tpu.optim import lm as jlm
from calibration_tpu.optim import lm_schur as jschur
from calibration_tpu.optim import planarpose as jpp
from calibration_tpu.optim import semidlt as jsd
from calibration_tpu.parallel import batched as jbatched
from calibration_tpu.parallel import sharding as jsharding
from calibration_tpu.pipeline.facades import linescan as jlsf
from calibration_tpu.utils import profiling as jprof
from calibration_tpu_torch.models import camera_matrix as tcm
from calibration_tpu_torch.models import distortion as tdist
from calibration_tpu_torch.models import pinhole as tpin
from calibration_tpu_torch.models import scheimpflug as tsch
from calibration_tpu_torch.ops import intrinsics_linear as tlin
from calibration_tpu_torch.ops import linalg as tlinalg
from calibration_tpu_torch.ops import linescan as tls
from calibration_tpu_torch.ops import planarpose as tplanar
from calibration_tpu_torch.ops import planefit as tpf
from calibration_tpu_torch.ops import ransac as transac
from calibration_tpu_torch.ops import se3 as tse3
from calibration_tpu_torch.optim import bundle as tbundle
from calibration_tpu_torch.optim import extrinsics as text
from calibration_tpu_torch.optim import handeye as the
from calibration_tpu_torch.optim import homography as thom
from calibration_tpu_torch.optim import intrinsics as tintr
from calibration_tpu_torch.optim import lm as tlm
from calibration_tpu_torch.optim import lm_schur as tschur
from calibration_tpu_torch.optim import planarpose as tpp
from calibration_tpu_torch.optim import semidlt as tsd
from calibration_tpu_torch.parallel import batched as tbatched
from calibration_tpu_torch.parallel import sharding as tsharding
from calibration_tpu_torch.pipeline.facades import linescan as tlsf
from calibration_tpu_torch.utils import profiling as tprof

PAIRS = {
    "optimize_intrinsics_device": (tintr, jintr),
    "optimize_intrinsics": (tintr, jintr),
    "intrinsics_covariance_device": (tintr, jintr),
    "optimize_extrinsics_device": (text, jext),
    "optimize_extrinsics": (text, jext),
    "optimize_handeye_device": (the, jhe),
    "optimize_handeye": (the, jhe),
    "estimate_and_optimize_handeye": (the, jhe),
    "optimize_homography_device": (thom, jhom),
    "optimize_homography": (thom, jhom),
    "homography_covariance_device": (thom, jhom),
    "optimize_bundle_device": (tbundle, jbundle),
    "optimize_bundle": (tbundle, jbundle),
    "lm_core": (tlm, jlm),
    "covariance": (tlm, jlm),
    "intrinsics_batch": (tbatched, jbatched),
    "intrinsics_facade_batch": (tbatched, jbatched),
    "extrinsics_batch": (tbatched, jbatched),
    "homography_batch": (tbatched, jbatched),
    "handeye_batch": (tbatched, jbatched),
    "reprojection_rms_batch": (tbatched, jbatched),
    "bundle_batch": (tbatched, jbatched),
    "linescan_batch": (tbatched, jbatched),
    "linescan_ransac_batch": (tbatched, jbatched),
    "ransac_plane": (transac, jransac),
    "fit_plane_svd": (tpf, jpf),
    "fit_plane_3pt": (tpf, jpf),
    "plane_point_distance": (tpf, jpf),
    "plane_rms": (tpf, jpf),
    "build_plane_homography": (tls, jls),
    "points_from_view": (tls, jls),
    "calibrate_laser_plane": (tls, jls),
    "undistort": (tdist, jdist),
    "pinhole.pack": (tpin, jpin),
    "pinhole.unproject": (tpin, jpin),
    "pinhole.project_normalized": (tpin, jpin),
    "pinhole.apply_intrinsics": (tpin, jpin),
    "pinhole.remove_intrinsics": (tpin, jpin),
    "pinhole.apply_linear_intrinsics": (tpin, jpin),
    "pinhole.remove_linear_intrinsics": (tpin, jpin),
    "scheimpflug.pack": (tsch, jsch),
    "scheimpflug.project": (tsch, jsch),
    "scheimpflug.unproject": (tsch, jsch),
    "scheimpflug.unproject_normalized": (tsch, jsch),
    "scheimpflug.plane_point_to_ray": (tsch, jsch),
    "scheimpflug.apply_intrinsics": (tsch, jsch),
    "scheimpflug.remove_intrinsics": (tsch, jsch),
    "LinescanCalibrationFacade.calibrate": (tlsf, jlsf),
    "apply_distortion": (tdist, jdist),
    "fit_distortion_full": (tdist, jdist),
    "fit_distortion": (tdist, jdist),
    "invert_brown_conrady": (tdist, jdist),
    "fit_distortion_dual": (tdist, jdist),
    "estimate_intrinsics_linear": (tlin, jlin),
    "estimate_intrinsics_linear_iterative": (tlin, jlin),
    "optimize_planar_pose_device": (tpp, jpp),
    "optimize_planar_pose": (tpp, jpp),
    "optimize_intrinsics_semidlt_device": (tsd, jsd),
    "optimize_intrinsics_semidlt": (tsd, jsd),
    "planar_pose_batch": (tbatched, jbatched),
    "make_mesh": (tsharding, jsharding),
    "mesh_devices": (tsharding, jsharding),
    "batch_sharding": (tsharding, jsharding),
    "shard_batch": (tsharding, jsharding),
    "pad_batch": (tsharding, jsharding),
    "make_lm_step": (tlm, jlm),
    "lm_cost_trace": (tprof, jprof),
    "device_trace": (tprof, jprof),
    "camera_matrix.from_matrix": (tcm, jcm),
    "pinhole.kmtx_of": (tpin, jpin),
    "pinhole.dist_of": (tpin, jpin),
    "pinhole.distort": (tpin, jpin),
    "pinhole.undistort_pt": (tpin, jpin),
    "se3_identity": (tse3, jse3),
    "pose_to_array": (tse3, jse3),
    "array_to_pose": (tse3, jse3),
    "homography_consistency_fro": (tplanar, jplanar),
    "full_jacobian": (tschur, jschur),
    "solve_llsq": (tlinalg, jlinalg),
    "min_singular_value": (tlinalg, jlinalg),
}


def _resolve(mod, key):
    """The object a PAIRS key names: its last dotted part, or for a
    ``Class.method`` key the method."""
    parts = key.split(".")
    if parts[0][0].isupper():
        return getattr(getattr(mod, parts[0]), parts[1])
    return getattr(mod, parts[-1])


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_matches_the_reference(name):
    port_mod, jax_mod = PAIRS[name]
    port = inspect.signature(_resolve(port_mod, name)).parameters
    ref = inspect.signature(_resolve(jax_mod, name)).parameters
    extra = [p for p in port.values() if p.name not in ref]
    assert all(p.kind is p.KEYWORD_ONLY for p in extra), f"port-only parameters must be keyword-only: {extra}"
    shared = [p for p in port.values() if p.name in ref]
    assert [p.name for p in shared] == list(ref), f"{name}: {list(port)} vs the reference's {list(ref)}"
    assert [p.kind for p in shared] == [p.kind for p in ref.values()], name


def test_the_reference_scheduler_name_is_not_reused():
    """The reference's phase_schedule(model_name, b, opts) has another
    contract than the port's iteration budget, which is private."""
    assert not hasattr(tbatched, "phase_schedule")
    assert tbatched._phase_budget(50, (5,)) == (5, 45)


def _z(*shape):
    return torch.zeros(shape, dtype=torch.float64)


def _intr_args(b=(1,)):
    return (_z(*b, 4, 6, 2), _z(*b, 4, 6, 2), _z(*b, 10), _z(*b, 4, 4, 4))


def _extr_args(b=(1,)):
    return (_z(*b, 3, 2, 6, 2), _z(*b, 3, 2, 6, 2), _z(*b, 2, 10), _z(*b, 2, 4, 4), _z(*b, 3, 4, 4))


def _bundle_args(b=(1,)):
    return (_z(*b, 3, 6, 2), _z(*b, 3, 6, 2), _z(*b, 3, 4, 4), torch.zeros(b + (3,), dtype=torch.long), _z(*b, 1, 10),
            _z(*b, 1, 4, 4), _z(*b, 4, 4))


def _mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("b",))


def _linescan_args(b=(1,)):
    return (_z(*b, 10), _z(*b, 2, 5, 2), _z(*b, 2, 5, 2), _z(*b, 2, 4, 2))


SCHEIM = SCHEIMPFLUG.name
UNPORTED = {
    "extrinsics_device_jac_mode": (text.optimize_extrinsics_device, _extr_args, {"jac_mode": "blocked"}),
    "extrinsics_device_jac_mode_model": (text.optimize_extrinsics_device, _extr_args,
                                         {"jac_mode": "per_view", "model": SCHEIMPFLUG}),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_values_raise(case):
    fn, args, kwargs = UNPORTED[case]
    with pytest.raises(NotImplementedError, match="not ported yet"):
        fn(*args(), **kwargs)


# every batch entry point takes a port mesh; these calls raised "not ported
# yet" before. The all-zero inputs never converge: a budget of 3 keeps them
# short.
_CORE = tintr.OptimOptions(max_iterations=3, compute_covariance=False)
_INTR_OPTS = {"opts": tintr.IntrinsicsOptimOptions(core=_CORE)}
MESH_TAKEN = {
    "linescan_batch_mesh": (tbatched.linescan_batch, _linescan_args, {}),
    "linescan_ransac_batch_mesh": (tbatched.linescan_ransac_batch, _linescan_args, {}),
    "intrinsics_batch_mesh": (tbatched.intrinsics_batch, lambda: _intr_args()[:2], _INTR_OPTS),
    "facade_batch_mesh": (tbatched.intrinsics_facade_batch, lambda: _intr_args()[:2], _INTR_OPTS),
    "extrinsics_batch_mesh": (tbatched.extrinsics_batch, _extr_args, {"opts": text.ExtrinsicOptions(core=_CORE)}),
    "homography_batch_mesh": (tbatched.homography_batch, lambda: (_z(1, 6, 2), _z(1, 6, 2)), {"options": _CORE}),
    "handeye_batch_mesh": (tbatched.handeye_batch, lambda: (_z(1, 3, 4, 4), _z(1, 3, 4, 4)), {"options": _CORE}),
    "bundle_batch_mesh": (tbatched.bundle_batch, _bundle_args, {"opts": tbundle.BundleOptions(core=_CORE)}),
    "planar_pose_batch_mesh": (tbatched.planar_pose_batch, lambda: (_z(1, 6, 2), _z(1, 6, 2), _z(1, 5)),
                               {"options": _CORE}),
}


@pytest.mark.parametrize("case", sorted(MESH_TAKEN))
def test_mesh_is_taken(case):
    """A one-device CPU mesh gives what mesh=None gives, NaN for NaN, on the
    same tiny inputs."""
    fn, args, kwargs = MESH_TAKEN[case]
    got = fn(*args(), mesh=tsharding.make_mesh(["cpu"]), **kwargs)
    want = fn(*args(), **kwargs)
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_jax_mesh_is_refused():
    with pytest.raises(TypeError, match="make_mesh"):
        tbatched.homography_batch(_z(1, 6, 2), _z(1, 6, 2), mesh=_mesh())


# the intrinsics solvers take "mixed" and "mixed_jac", the bundle solver
# "mixed" (tests/test_torch_mixed.py holds them to JAX); these calls raised
# "not ported yet" before. The bundle solver refuses "mixed_jac", which the
# reference takes and ignores.
PRECISION_TAKEN = {
    "intrinsics_device_mixed": (tintr.optimize_intrinsics_device, _intr_args, "mixed", _INTR_OPTS),
    "intrinsics_device_mixed_jac": (tintr.optimize_intrinsics_device, _intr_args, "mixed_jac", _INTR_OPTS),
    "intrinsics_host_mixed": (tintr.optimize_intrinsics, lambda: _intr_args(()), "mixed", _INTR_OPTS),
    "bundle_device_mixed": (tbundle.optimize_bundle_device, _bundle_args, "mixed",
                            {"opts": tbundle.BundleOptions(core=_CORE)}),
    "bundle_device_mixed_jac": (tbundle.optimize_bundle_device, _bundle_args, "mixed_jac", {}),
    "intrinsics_batch_mixed": (tbatched.intrinsics_batch, lambda: _intr_args()[:2], "mixed", _INTR_OPTS),
    "facade_batch_mixed": (tbatched.intrinsics_facade_batch, lambda: _intr_args()[:2], "mixed", _INTR_OPTS),
}


@pytest.mark.parametrize("case", sorted(PRECISION_TAKEN))
def test_mixed_precisions_are_taken(case):
    fn, args, precision, kwargs = PRECISION_TAKEN[case]
    if case == "bundle_device_mixed_jac":
        with pytest.raises(ValueError, match="mixed_jac"):
            fn(*args(), precision=precision)
    else:
        assert fn(*args(), precision=precision, **kwargs) is not None


def test_honoured_reference_values_are_accepted():
    """The reference's own defaults, passed by keyword, change nothing:
    model PINHOLE (the reference's spec, its name, the "pinhole" alias or
    the port's spec) is taken and gives the port's pinhole spec on every
    caller's list of models, precision "f64", mesh None, any analytic_jac
    (the analytic Jacobian equals jacfwd)."""
    from calibration_tpu.models.registry import PINHOLE
    from calibration_tpu_torch.models import registry as treg
    from calibration_tpu_torch.optim.core import check_ported

    obj = torch.tensor(np.random.default_rng(0).uniform(-1, 1, (2, 8, 2)))
    dst = obj * 1.1 + 0.2
    base = tbatched.homography_batch(obj, dst, two_phase=False)
    same = tbatched.homography_batch(obj, dst, mesh=None, two_phase=False)
    assert torch.equal(base[1], same[1])
    callers = {"default": {}, "intrinsics": {"models": tintr.MODELS},
               "linescan": {"models": tbatched.LINESCAN_MODELS}}
    for kwargs in callers.values():
        for model in (PINHOLE, PINHOLE.name, "pinhole", tintr.PINHOLE):
            assert check_ported(model, **kwargs) is treg.PINHOLE


# the intrinsics solvers take the Scheimpflug model (the reference's spec
# object or its name); these calls raised "not ported yet" before
SCHEIMPFLUG_TAKEN = {
    "intrinsics_device_model": (tintr.optimize_intrinsics_device, {"model": SCHEIMPFLUG}),
    "intrinsics_host_model": (tintr.optimize_intrinsics, {"model": SCHEIMPFLUG}),
    "intrinsics_covariance_model": (tintr.intrinsics_covariance_device, {"model": SCHEIMPFLUG}),
    "intrinsics_batch_model": (tbatched.intrinsics_batch, {"model_name": SCHEIM}),
    "facade_batch_model": (tbatched.intrinsics_facade_batch, {"model_name": SCHEIM}),
}


@pytest.mark.parametrize("case", sorted(SCHEIMPFLUG_TAKEN))
def test_scheimpflug_is_taken_where_ported(case):
    """A batch of one camera (4 views of a 4x5 grid through the port's
    Scheimpflug model, noise-free) solves to the truth's cost on every
    intrinsics entry point that now takes the model."""
    fn, kwargs = SCHEIMPFLUG_TAKEN[case]
    obj, uv, intr12, poses = _scheimpflug_views()
    opts = tintr.IntrinsicsOptimOptions(core=tintr.OptimOptions(max_iterations=5, compute_covariance=False))
    if fn is tintr.optimize_intrinsics:
        out = fn(obj[0], uv[0], intr12[0], poses[0], opts=opts, **kwargs)
        assert out.camera.shape == (12,) and out.core.final_cost < 1e-16
    elif fn is tintr.intrinsics_covariance_device:
        cov, ok = fn(obj, uv, intr12, poses, opts=opts, **kwargs)
        assert cov.shape == (1, 12 + 28, 12 + 28) and bool(ok.all())
    elif fn is tintr.optimize_intrinsics_device:
        out = fn(obj, uv, intr12, poses, opts=opts, **kwargs)
        assert out[1].shape == (1, 12) and float(out[0].cost[0]) < 1e-16
    else:
        out = fn(obj, uv, opts=opts, **kwargs)
        solve = out[1] if fn is tbatched.intrinsics_batch else out[2]
        assert solve[1].shape == (1, 12) and bool(torch.isfinite(solve[0].cost).all())


def _scheimpflug_views():
    """(obj, uv, intr (1, 12), poses (1, 4, 4, 4)) of one noise-free camera
    through the port's Scheimpflug model."""
    from calibration_tpu_torch.models import scheimpflug
    from calibration_tpu_torch.ops import se3

    ys, xs = np.meshgrid(np.arange(4), np.arange(5), indexing="ij")
    grid = np.stack([xs.ravel() * 0.05, ys.ravel() * 0.05], -1) - [0.1, 0.075]
    ang = 2 * np.pi * np.arange(4) / 4
    w = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.1 * np.sin(2 * ang)], -1)
    t = np.stack([0.05 * np.cos(ang), 0.05 * np.sin(ang), np.full(4, 0.8)], -1)
    poses = torch.eye(4, dtype=torch.float64).repeat(1, 4, 1, 1)
    poses[0, :, :3, :3] = se3.exp_so3(torch.as_tensor(w))
    poses[0, :, :3, 3] = torch.as_tensor(t)
    intr = torch.tensor([[600.0, 610.0, 320.0, 240.0, 0.0, -0.1, 0.03, 0.0, 0.0, 0.0, 0.05, -0.04]],
                        dtype=torch.float64)
    pts = torch.cat([torch.as_tensor(grid), torch.zeros(len(grid), 1, dtype=torch.float64)], -1)
    pc = torch.einsum("vij,nj->vni", poses[0, :, :3, :3], pts) + poses[0, :, None, :3, 3]
    obj = torch.as_tensor(np.broadcast_to(grid, (1, 4) + grid.shape).copy())
    return obj, scheimpflug.project(intr[0], pc)[None], intr, poses


def _scheimpflug_rig_args():
    """Noise-free (extrinsics args, bundle args) with a batch of one, from
    the truth, through the port's Scheimpflug model: a two-camera rig
    seeing the 4 views of ``_scheimpflug_views``, and a one-camera robot
    cell (hand-eye and target poses the identity) with those views as its
    observations."""
    from calibration_tpu_torch.models import scheimpflug
    from calibration_tpu_torch.ops import se3

    obj, uv, intr, poses = _scheimpflug_views()
    off = torch.eye(4, dtype=torch.float64)
    off[:3, :3] = se3.exp_so3(torch.tensor([0.02, -0.3, 0.01], dtype=torch.float64))
    off[:3, 3] = torch.tensor([-0.2, 0.0, 0.02], dtype=torch.float64)
    pts = torch.cat([obj[0, 0], torch.zeros(obj.shape[2], 1, dtype=torch.float64)], -1)
    cam1 = off @ poses[0]
    uv1 = scheimpflug.project(intr[0], torch.einsum("vij,nj->vni", cam1[:, :3, :3], pts) + cam1[:, None, :3, 3])
    extr = (torch.stack([obj[0], obj[0]], 1)[None], torch.stack([uv[0], uv1], 1)[None], intr.expand(2, 12)[None],
            torch.stack([torch.eye(4, dtype=torch.float64), off])[None], poses)
    bundle = (obj, uv, se3.se3_inverse(poses), torch.zeros((1, 4), dtype=torch.long), intr[:, None],
              torch.eye(4, dtype=torch.float64)[None, None], torch.eye(4, dtype=torch.float64)[None])
    return extr, bundle


# the extrinsics and bundle solvers take every registry model (the
# reference's spec object or its name); these calls raised "not ported
# yet" before
ANY_MODEL_TAKEN = {
    "extrinsics_device_model": (text.optimize_extrinsics_device, {"model": SCHEIMPFLUG}),
    "extrinsics_host_model": (text.optimize_extrinsics, {"model": SCHEIMPFLUG}),
    "extrinsics_batch_model": (tbatched.extrinsics_batch, {"model_name": SCHEIM}),
    "bundle_device_model": (tbundle.optimize_bundle_device, {"model": SCHEIMPFLUG}),
    "bundle_host_model": (tbundle.optimize_bundle, {"model": "scheimpflug"}),
}


@pytest.mark.parametrize("case", sorted(ANY_MODEL_TAKEN))
def test_scheimpflug_is_taken_by_extrinsics_and_bundle(case):
    """From the truth, each entry point keeps the Scheimpflug cameras
    (12 parameters) and the cost of noise-free data."""
    fn, kwargs = ANY_MODEL_TAKEN[case]
    extr, bundle = _scheimpflug_rig_args()
    core = tintr.OptimOptions(max_iterations=5, compute_covariance=False)
    if fn in (text.optimize_extrinsics_device, text.optimize_extrinsics, tbatched.extrinsics_batch):
        opts = text.ExtrinsicOptions(core=core)
        host = fn is text.optimize_extrinsics
        out = fn(*(a[0] for a in extr) if host else extr, opts=opts, **kwargs)
        cams, cost = (out.cameras, out.core.final_cost) if host else (out[1][0], float(out[0].cost[0]))
    else:
        opts = tbundle.BundleOptions(core=core)
        host = fn is tbundle.optimize_bundle
        out = fn(*(a[0] for a in bundle) if host else bundle, opts=opts, **kwargs)
        cams, cost = (out.cameras, out.core.final_cost) if host else (out[1][0], float(out[0].cost[0]))
    assert tuple(cams.shape) == ((2, 12) if "extrinsics" in case else (1, 12))
    assert cost < 1e-16
