"""The port's device mesh (``parallel/sharding.py`` and the ``mesh``
argument of the batch entry points) against the JAX package's, CPU,
float64.

torch has one CPU device, so a 4-shard CPU mesh lists it four times: the
batch is padded with copies of problem 0 to a multiple of 4, split, the
shards solved in turn (one host thread per distinct device), and the
outputs gathered and trimmed, as on a card. Bars: homography on a 4-shard mesh against JAX's
on a 4-device virtual CPU mesh, counters exact and H within 1e-10; the
intrinsics, extrinsics and bundle batches on the 4-shard mesh against the
port's and JAX's unsharded single-phase calls, counters exact and cost
within 1e-10 relative; planar pose, a Scheimpflug intrinsics batch,
line-scan RANSAC and hand-eye on the mesh against the port unsharded. With
a thread per shard, as on a mesh of distinct cards, the forward-mode
paths (planar pose, Scheimpflug, homography) raise without
``lm.FORWARD_AD_LOCK``: PyTorch keeps forward-AD levels per process."""

import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from calibration_tpu.optim import BundleOptions as JBundleOptions
from calibration_tpu.optim import ExtrinsicOptions as JExtrinsicOptions
from calibration_tpu.optim import IntrinsicsOptimOptions as JIntrOptions
from calibration_tpu.optim import OptimOptions as JOptimOptions
from calibration_tpu.parallel import batched as jb
from calibration_tpu.parallel import sharding as jsh
from calibration_tpu_torch import convert
from calibration_tpu_torch.models.registry import SCHEIMPFLUG
from calibration_tpu_torch.ops.ransac import RansacOptions
from calibration_tpu_torch.optim import IntrinsicsOptimOptions, OptimOptions
from calibration_tpu_torch.parallel import batched as tb
from calibration_tpu_torch.parallel import sharding as tsh
from torch_helpers import camera_views, one_torch_thread, t64  # noqa: F401

MESH = tsh.make_mesh(["cpu"] * 4)
B = 6  # pads to 8 on the 4-shard mesh
COUNTERS = ("iterations", "linearizations", "termination", "success")
JCORE = JOptimOptions(max_iterations=40, epsilon=1e-9, compute_covariance=False)


def _same_counters(t_lm, want_lm, counters=COUNTERS):
    for name in counters:
        np.testing.assert_array_equal(np.asarray(getattr(t_lm, name)), np.asarray(getattr(want_lm, name)), name)


def _cost_close(t_lm, want_lm):
    np.testing.assert_allclose(np.asarray(t_lm.cost), np.asarray(want_lm.cost), rtol=1e-10)


def test_pad_batch_matches_jax():
    rng = np.random.default_rng(3)
    tree = (rng.normal(size=(6, 3)), rng.integers(0, 5, (6,)), rng.normal(size=(6, 2, 2)))
    j_tree, j_b = jsh.pad_batch(tree, 4)
    t_tree, t_b = tsh.pad_batch(tuple(torch.as_tensor(a) for a in tree), 4)
    n_tree, n_b = tsh.pad_batch(tree, 4)
    assert j_b == t_b == n_b == 6
    for j, t, n in zip(j_tree, t_tree, n_tree):
        assert t.shape[0] == 8 and isinstance(n, np.ndarray)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(n, np.asarray(j))
    same, b = tsh.pad_batch(tree, 3)
    assert same is tree and b == 6


def test_shard_batch_splits_replicates_and_warns():
    x = torch.arange(16.0).reshape(8, 2)
    shared = torch.ones(3)
    shards = tsh.shard_batch((x, shared, None, "pinhole"), MESH)
    assert len(shards) == 4
    for i, (xi, si, none, name) in enumerate(shards):
        assert torch.equal(xi, x[2 * i : 2 * i + 2]) and torch.equal(si, shared)
        assert none is None and name == "pinhole"
    assert tsh.batch_sharding(MESH).mesh is MESH
    with pytest.warns(UserWarning, match="REPLICATED"):
        (odd,), *_ = tsh.shard_batch((torch.zeros(6, 2),), MESH)
    assert odd.shape == (6, 2)


def test_meshes_never_fall_back_to_the_cpu(monkeypatch):
    assert MESH.size == 4 and all(d == torch.device("cpu") for d in MESH.devices)
    assert MESH.axis_name == tsh.BATCH_AXIS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsh.make_mesh()
    assert tsh.mesh_devices() is None and tsh.mesh_devices(2, probe=True) is None
    with pytest.raises(ValueError, match="at least one device"):
        tsh.make_mesh([])


def test_homography_mesh_matches_jax():
    _, src, dst = chip_smoke.homography_problems(10)
    jmesh = jsh.make_mesh(jax.devices("cpu")[:4])
    j_lm, j_h, _, _ = jax.device_get(
        jb.homography_batch(src, dst, options=JCORE, mesh=jmesh, seed_precision="f64")
    )
    topts = convert.optim_options(JCORE)
    t_lm, t_h, _, _ = tb.homography_batch(t64(src), t64(dst), options=topts, mesh=MESH)
    one_lm, one_h, _, _ = tb.homography_batch(t64(src), t64(dst), options=topts, two_phase=False)
    assert t_h.shape == (10, 3, 3) and bool(t_lm.success.all())
    for want_lm, want_h in ((j_lm, j_h), (one_lm, one_h)):
        _same_counters(t_lm, want_lm)
        np.testing.assert_allclose(t_h.numpy(), np.asarray(want_h), rtol=1e-10, atol=1e-10)


def _intrinsics():
    obj, uv, _, _ = camera_views(B, 4, noise=0.2, seed=31)
    jopts = JIntrOptions(core=JCORE)
    return (
        lambda **kw: tb.intrinsics_batch(t64(obj), t64(uv), opts=convert.intrinsics_options(jopts), **kw)[1][0],
        lambda: jb.intrinsics_batch(obj, uv, opts=jopts, two_phase=False)[1][0],
    )


def _extrinsics():
    p = chip_smoke.stereo_problems(B)
    args = [p[k] for k in ("obj", "uv", "intr0", "c0", "r0")]
    jopts = JExtrinsicOptions(core=JCORE)
    return (
        lambda **kw: tb.extrinsics_batch(*map(t64, args), opts=convert.extrinsic_options(jopts), **kw)[0],
        lambda: jb.extrinsics_batch(*args, opts=jopts, two_phase=False)[0],
    )


def _bundle():
    args = chip_smoke.bundle_args(chip_smoke.bundle_problems(B, num_obs=8, rows=5, cols=7), "cpu")
    jopts = JBundleOptions(core=JCORE)
    return (
        lambda **kw: tb.bundle_batch(*args, opts=convert.bundle_options(jopts), **kw)[0],
        lambda: jb.bundle_batch(*(a.numpy() for a in args), opts=jopts, two_phase=False)[0],
    )


@pytest.mark.parametrize("make", [_intrinsics, _extrinsics, _bundle], ids=["intrinsics", "extrinsics", "bundle"])
def test_mesh_matches_unsharded_and_jax(make):
    port, ref = make()
    t_lm = port(mesh=MESH)
    assert t_lm.cost.shape == (B,) and bool(t_lm.success.all())
    for want in (port(two_phase=False), jax.device_get(ref())):
        _same_counters(t_lm, want)
        _cost_close(t_lm, want)


@pytest.fixture
def thread_per_shard(monkeypatch):
    """Each shard on a host thread of its own, as on a mesh of distinct
    cards."""
    monkeypatch.setattr(tb, "_by_device", lambda devices: [[i] for i in range(len(devices))])


def _planar_pose(mesh, lanes=10):
    obj, uv, kmtx, _ = chip_smoke.planar_problems(1)
    return tb.planar_pose_batch(*(t64(a[:lanes]) for a in (obj, uv, kmtx)), options=chip_smoke.PLANAR_OPTS,
                                mesh=mesh)[0]


def test_planar_pose_on_mesh_matches_unsharded(thread_per_shard):
    """Each shard linearizes with dual numbers on its own thread: the
    forward-AD lock."""
    t_lm, one = _planar_pose(MESH), _planar_pose(None)
    _same_counters(t_lm, one, chip_smoke.PLANAR_PARITY_COUNTERS)
    _cost_close(t_lm, one)


def test_scheimpflug_intrinsics_on_mesh_matches_unsharded(thread_per_shard):
    """The forward-mode Schur Jacobian on every shard's thread."""
    obj, uv, _ = chip_smoke.scheimpflug_problems(3, (0.05, -0.04), views=4, rows=5, cols=7)
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=30, compute_covariance=False),
                                  fixed_distortion_indices=(2, 3))
    run = lambda **kw: tb.intrinsics_batch(t64(obj), t64(uv), opts=opts, model_name=SCHEIMPFLUG.name, **kw)[1]
    t_out, one = run(mesh=MESH), run(two_phase=False)
    assert t_out[1].shape == (3, 12)
    _same_counters(t_out[0], one[0])
    _cost_close(t_out[0], one[0])


def test_shards_of_one_device_share_a_thread():
    assert tb._by_device(MESH.devices) == [[0, 1, 2, 3]]
    cards = tsh.Mesh(tuple(torch.device("cuda", i) for i in (0, 1, 0, 2)))
    assert tb._by_device(cards.devices) == [[0, 2], [1], [3]]


def test_forward_ad_lock_holds_under_thread_stress(thread_per_shard):
    """16 shards of one lane each, each on its own thread, more threads
    than cores, the interpreter switching threads every microsecond: every
    shard's dual level stays its own, and the gather keeps the shards'
    order."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t_lm = _planar_pose(tsh.make_mesh(["cpu"] * 16), lanes=16)
    finally:
        sys.setswitchinterval(prev)
    one = _planar_pose(None, lanes=16)
    _same_counters(t_lm, one, chip_smoke.PLANAR_PARITY_COUNTERS)
    _cost_close(t_lm, one)


def test_ransac_and_handeye_on_mesh_equal_unsharded():
    """RANSAC draws are the same for every lane whatever its shard (each
    round's noise comes from the seed and the round), so padding and
    splitting leave the line-scan planes and inlier counts as they are;
    hand-eye has no phases and gives the same bits."""
    camera, obj, tuv, luv, _ = chip_smoke.linescan_problems(5, seed=31)
    args = [t64(a) for a in (camera, obj, tuv, chip_smoke.with_laser_outliers(luv, 31))]
    opts = RansacOptions(**chip_smoke.LINESCAN_RANSAC_OPTS)
    got, want = (tb.linescan_ransac_batch(*args, options=opts, mesh=m) for m in (MESH, None))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _, bg, ct = chip_smoke.handeye_problems(5, num_poses=6)
    got, want = (tb.handeye_batch(t64(bg), t64(ct), options=OptimOptions(max_iterations=30), mesh=m)
                 for m in (MESH, None))
    _same_counters(got[0], want[0])
    assert torch.equal(got[1], want[1])
