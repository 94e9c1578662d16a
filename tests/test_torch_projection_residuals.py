"""The port of the fused f32 projection-residual kernel
(calibration_tpu_torch.ops.projection_residuals): its plain version against
the JAX Pallas kernel in interpret mode and against the exact float64 numpy
oracle, the wrapper's device dispatch and launch count, and the fleet QA
scorer built on it. The CUDA kernel itself runs only on a card
(tests/test_torch_cuda.py); ``chip_smoke.py`` holds it against the plain
version there too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from calibration_tpu.ops import pallas_kernels as pk
from calibration_tpu.parallel import reprojection_rms_batch as jax_rms_batch
from calibration_tpu_torch.kernels import _build
from calibration_tpu_torch.ops import projection_residuals as pr
from calibration_tpu_torch.parallel import reprojection_rms_batch
from test_pallas_kernels import _numpy_oracle, _problem
from torch_helpers import one_torch_thread, t64  # noqa: F401

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
    before = pr.launches
    pr.projection_residuals_f32(*_torch_args(_problem()))
    assert pr.launches == before


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

