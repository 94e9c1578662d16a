"""The port of the fused f32 projection-residual kernel
(calibration_tpu_torch.ops.projection_residuals): its plain versions
(residuals and the per-view RMS) against the JAX Pallas kernel in interpret
mode, JAX's reprojection_rms_batch and the exact float64 numpy oracle, the
wrappers' device dispatch and launch counts, the kernel's argument building
(pointers, strides, dims), and the fleet QA scorer built on it. The CUDA
kernel itself runs only on a card (tests/test_torch_cuda.py);
``chip_smoke.py`` holds it against the plain versions there too.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibration_tpu.ops import pallas_kernels as pk
from calibration_tpu.parallel import reprojection_rms_batch as jax_rms_batch
from calibration_tpu.parallel.batched import _rms_from_residuals as jax_rms_from_residuals
from calibration_tpu_torch.kernels import _build
from calibration_tpu_torch.ops import projection_residuals as pr
from calibration_tpu_torch.parallel import reprojection_rms_batch
from test_pallas_kernels import _numpy_oracle, _problem
from torch_helpers import k1_launches, one_torch_thread, t64  # noqa: F401

ATOL_PX = 5e-3  # f32 rounding of ~640 px values (the JAX kernel's gate)
SHAPES = [(5, 37, 2), (19, 150, 5)]  # the JAX kernel tests' shapes, seeds


def _torch_args(arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


@pytest.mark.parametrize("r,n,seed", SHAPES)
def test_plain_matches_pallas_interpret_and_oracle(r, n, seed):
    arrays = _problem(r=r, n=n, seed=seed)
    ref = _numpy_oracle(*arrays)
    pallas = np.asarray(pk.projection_residuals_f32(*(jnp.asarray(a) for a in arrays), interpret=True))
    got = pr.projection_residuals_f32(*_torch_args(arrays)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL_PX)
    np.testing.assert_allclose(got, pallas, atol=ATOL_PX)
    assert np.all(got[~arrays[5]] == 0.0)


@pytest.mark.parametrize("r,n,seed", SHAPES)
def test_plain_f64_is_the_exact_oracle(r, n, seed):
    arrays = _problem(r=r, n=n, seed=seed)
    got = pr.projection_residuals_plain(*_torch_args(arrays, torch.float64)).numpy()
    np.testing.assert_allclose(got, _numpy_oracle(*arrays), rtol=1e-12, atol=1e-9)


def test_cpu_route_does_not_count_launches():
    before = k1_launches()
    pr.projection_residuals_f32(*_torch_args(_problem()))
    pr.projection_rms_f32(*(torch.as_tensor(a) for a in _rms_problem(_problem())))
    assert k1_launches() == before


def test_wrapper_rejects_bad_shapes_and_devices():
    args = _torch_args(_problem())
    with pytest.raises(ValueError, match="intr"):
        pr.projection_residuals_f32(args[0], args[1], args[2][:, :5], *args[3:])
    # no silent plain fallback on a device without the kernel
    with pytest.raises(ValueError, match="no kernel"):
        pr.projection_residuals_f32(*(a.to("meta") for a in args))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_library_path_is_keyed_by_sources():
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent.parent == _build.BUILD_ROOT


def test_reprojection_rms_batch_matches_f64_and_jax():
    rot, tra, intr, obj, uv, mask = _problem(r=12, n=37, seed=4)
    b, v = 4, 3
    poses = np.tile(np.eye(4)[None], (12, 1, 1))
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = tra
    intr_b = intr.reshape(b, v, 10)[:, 0]
    args = (poses.reshape(b, v, 4, 4), intr_b, obj.reshape(b, v, -1, 2), uv.reshape(b, v, -1, 2),
            mask.reshape(b, v, -1))
    got = reprojection_rms_batch(*(t64(a) for a in args)).numpy()
    assert got.dtype == np.float32
    res = _numpy_oracle(rot, tra, np.repeat(intr_b, v, axis=0), obj, uv, mask)
    ref = np.sqrt((res**2).sum((-2, -1)) / (2.0 * np.maximum(mask.sum(-1), 1))).reshape(b, v)
    np.testing.assert_allclose(got, ref, rtol=2e-3)
    np.testing.assert_allclose(got, np.asarray(jax_rms_batch(*args)), rtol=2e-3)



def _rms_problem(arrays):
    """_problem's R rows as R cameras of one view each: c_se3_t (R, 1, 4, 4),
    intrs (R, 10), obj_xy/img_uv (R, 1, N, 2), mask (R, 1, N)."""
    rot, tra, intr, obj, uv, mask = arrays
    poses = np.tile(np.eye(4), (rot.shape[0], 1, 1))
    poses[:, :3, :3] = rot
    poses[:, :3, 3] = tra
    return poses[:, None], intr, obj[:, None], uv[:, None], mask[:, None]


@pytest.mark.parametrize("r,n,seed", SHAPES)
def test_plain_rms_matches_jax(r, n, seed):
    """The plain RMS equals JAX's reprojection_rms_batch and JAX's RMS over
    the Pallas kernel (interpret mode), in float32 up to summation order."""
    arrays = _problem(r=r, n=n, seed=seed)
    args = _rms_problem(arrays)
    got = pr.projection_rms_plain(*(torch.as_tensor(a) for a in args)).numpy()
    assert got.dtype == np.float32 and got.shape == (r, 1)
    pallas = pk.projection_residuals_f32(*(jnp.asarray(a) for a in arrays), interpret=True)
    via_pallas = np.asarray(jax_rms_from_residuals(pallas, jnp.asarray(arrays[5], jnp.float32)))
    np.testing.assert_allclose(got[:, 0], via_pallas, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_rms_batch(*args)), rtol=1e-5)


@pytest.mark.parametrize("r,n,seed", SHAPES)
def test_plain_rms_same_bits_from_f64_and_f32(r, n, seed):
    args = _rms_problem(_problem(r=r, n=n, seed=seed))
    f64 = pr.projection_rms_plain(*(torch.as_tensor(a) for a in args))
    f32 = pr.projection_rms_plain(*(torch.as_tensor(a, dtype=torch.float32) for a in args[:4]),
                                  torch.as_tensor(args[4]))
    assert torch.equal(f64, f32)


def test_plain_rms_of_all_masked_row_is_zero():
    poses, intrs, obj, uv, mask = _rms_problem(_problem(r=5, n=37, seed=2))
    mask = mask.copy()
    mask[3] = False
    got = pr.projection_rms_f32(*(torch.as_tensor(a) for a in (poses, intrs, obj, uv, mask)))
    assert float(got[3, 0]) == 0.0 and bool((got[[0, 1, 2, 4]] > 0).all())


def _rms_views(b=3, v=4, n=37, dtype=torch.float64):
    poses, intrs, obj, uv, mask = _rms_problem(_problem(r=b * v, n=n, seed=3))
    return (
        torch.as_tensor(poses.reshape(b, v, 4, 4), dtype=dtype),
        torch.as_tensor(intrs.reshape(b, v, 10)[:, 0].copy(), dtype=dtype),
        torch.as_tensor(obj.reshape(b, v, n, 2), dtype=dtype),
        torch.as_tensor(uv.reshape(b, v, n, 2), dtype=dtype),
        torch.as_tensor(mask.reshape(b, v, n), dtype=dtype),
    )


def test_launch_args_read_the_callers_tensors_in_place():
    """RMS mode from contiguous float64: every pointer is the caller's own
    data_ptr() (the translation 3 elements into the pose), the intrinsics'
    view stride is 0, nothing is copied."""
    c_se3_t, intrs, obj, uv, mask = _rms_views()
    out = torch.empty((3, 4), dtype=torch.float32)
    args = pr.launch_args(*pr._rms_views(c_se3_t, intrs, obj, uv, mask), out)
    assert (args.rot, args.tra, args.intr) == (c_se3_t.data_ptr(), c_se3_t.data_ptr() + 24, intrs.data_ptr())
    assert (args.obj, args.uv, args.mask, args.out) == (obj.data_ptr(), uv.data_ptr(), mask.data_ptr(), out.data_ptr())
    assert (args.batch, args.views, args.points, args.scalar, args.mask_kind) == (3, 4, 37, 1, 2)
    assert (args.rot_b, args.rot_v, args.rot_i, args.rot_j) == (64, 16, 4, 1)
    assert (args.tra_b, args.tra_v, args.tra_i) == (64, 16, 4)
    assert (args.intr_b, args.intr_v, args.intr_k) == (10, 0, 1)
    assert (args.obj_b, args.obj_v, args.uv_b, args.uv_v) == (4 * 37 * 2, 37 * 2, 4 * 37 * 2, 37 * 2)
    assert (args.mask_b, args.mask_v, args.mask_n) == (4 * 37, 37, 1)


def test_launch_args_residual_mode_rows():
    rot, tra, intr, obj, uv, mask = (t.unsqueeze(1) for t in _torch_args(_problem(r=5, n=37)))
    out = torch.empty((5, 1, 37, 2), dtype=torch.float32)
    args = pr.launch_args(rot, tra, intr, obj, uv, mask, out)
    assert (args.batch, args.views, args.points, args.scalar, args.mask_kind) == (5, 1, 37, 0, 1)
    assert (args.rot_b, args.tra_b, args.intr_b, args.obj_b, args.mask_b) == (9, 3, 10, 74, 37)


def _bad(name):
    c_se3_t, intrs, obj, uv, mask = _rms_views()
    views = dict(zip(("rot", "tra", "intr", "obj", "uv", "mask"), pr._rms_views(c_se3_t, intrs, obj, uv, mask)))
    out = torch.empty((3, 4), dtype=torch.float32)
    if name == "f16 points":
        views["obj"], views["uv"] = views["obj"].half(), views["uv"].half()
    elif name == "mixed dtypes":
        views["obj"] = views["obj"].float()
    elif name == "int mask":
        views["mask"] = views["mask"].int()
    elif name == "short intrinsics":
        views["intr"] = views["intr"][..., :5]
    elif name == "strided points":
        views["obj"] = torch.empty((3, 4, 2, 37), dtype=torch.float64).transpose(-1, -2)
    elif name == "misaligned points":
        views["obj"] = torch.empty(3 * 4 * 37 * 2 + 1, dtype=torch.float64)[1:].view(3, 4, 37, 2)
    elif name == "f64 out":
        out = out.double()
    return views, out


@pytest.mark.parametrize("name", [
    "f16 points", "mixed dtypes", "int mask", "short intrinsics", "strided points",
    "misaligned points", "f64 out",
])
def test_launch_args_rejects_what_the_kernel_does_not_take(name):
    views, out = _bad(name)
    with pytest.raises(ValueError):
        pr.launch_args(*views.values(), out)


def test_rms_wrapper_rejects_bad_shapes_and_devices():
    c_se3_t, intrs, obj, uv, mask = _rms_views()
    with pytest.raises(ValueError, match="intrs"):
        pr.projection_rms_f32(c_se3_t, intrs[:2], obj, uv, mask)
    with pytest.raises(ValueError, match="c_se3_t"):
        pr.projection_rms_f32(c_se3_t[..., :3, :], intrs, obj, uv, mask)
    with pytest.raises(ValueError, match="no kernel"):
        pr.projection_rms_f32(*(a.to("meta") for a in (c_se3_t, intrs, obj, uv, mask)))


def test_launch_args_struct_mirrors_the_cuda_source():
    """The ctypes struct lists the CUDA struct's fields in its order, all 8
    bytes wide (the source is compiled only on the card)."""
    src = Path(pr.__file__).resolve().parent.parent / "csrc" / "projection_residuals.cu"
    body = re.search(r"struct LaunchArgs \{(.*?)\};", src.read_text(), re.S).group(1)
    fields = re.findall(r"^\s*(?:const )?(?:void\*|int64_t) (\w+);", body, re.M)
    assert fields == [name for name, _ in pr.LaunchArgs._fields_]
    assert pr.ctypes.sizeof(pr.LaunchArgs) == 8 * len(fields)
