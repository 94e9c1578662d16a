"""Card-only tests of the PyTorch port: the CUDA projection-residual kernel
against its plain version, and the facade on the card against the same
facade on the CPU. Every test here is marked ``cuda`` and skips without a
CUDA device. This file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from calibration_tpu_torch.models import pinhole
from calibration_tpu_torch.ops import projection_residuals as pr
from calibration_tpu_torch.ops import se3
from calibration_tpu_torch.optim import IntrinsicsOptimOptions, OptimOptions
from calibration_tpu_torch.parallel import intrinsics_facade_batch

pytestmark = pytest.mark.cuda

ATOL_PX = 5e-3  # f32 rounding of ~640 px values (the JAX kernel's gate)
CAMERA = np.array([600.0, 610.0, 320.0, 240.0, 0.0, -0.15, 0.05, 0.0, 1e-4, -2e-4])


@pytest.fixture
def cuda_device():
    """A CUDA device, or a skip: decided when the test runs, never at
    import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(r, n, seed):
    rng = np.random.default_rng(seed)
    intr = np.tile(CAMERA, (r, 1))
    intr[:, 0] += rng.normal(0, 5, r)
    rot = se3.exp_so3(torch.as_tensor(rng.normal(0, 0.2, (r, 3)))).numpy()
    tra = rng.normal(0, 0.05, (r, 3)) + [0, 0, 1.0]
    obj = rng.uniform(-0.15, 0.15, (r, n, 2))
    uv = rng.uniform(0, 640, (r, n, 2))
    mask = rng.uniform(size=(r, n)) > 0.2
    return rot, tra, intr, obj, uv, mask


@pytest.mark.parametrize("r,n,seed", [(5, 37, 2), (19, 150, 5), (2560, 88, 11), (70000, 3, 1)])
def test_kernel_matches_plain(cuda_device, r, n, seed):
    arrays = _rows(r, n, seed)
    before = pr.launches
    got = pr.projection_residuals_f32(*(torch.as_tensor(a, device=cuda_device) for a in arrays))
    torch.cuda.synchronize()
    assert pr.launches == before + 1
    ref = pr.projection_residuals_plain(
        *(torch.as_tensor(a, dtype=torch.float64, device=cuda_device) for a in arrays)
    )
    assert float((got.double() - ref).abs().max()) <= ATOL_PX
    assert bool((got[~torch.as_tensor(arrays[5], device=cuda_device)] == 0).all())


def test_facade_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(3)
    b, v = 8, 6
    ang = 2 * np.pi * np.arange(v)[None, :] / v + 0.05 * np.arange(b)[:, None]
    w = np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang), 0.1 * np.sin(2 * ang)], -1)
    t = np.stack([0.06 * np.cos(ang), 0.06 * np.sin(ang), 0.9 + 0.08 * np.sin(ang)], -1)
    ys, xs = np.meshgrid(np.arange(5), np.arange(7), indexing="ij")
    grid = np.stack([xs.ravel() * 0.04, ys.ravel() * 0.04], -1)
    grid = grid - grid.mean(0)
    rot = se3.exp_so3(torch.as_tensor(w))
    pts = torch.as_tensor(np.concatenate([grid, np.zeros((len(grid), 1))], -1))
    pc = torch.einsum("bvij,nj->bvni", rot, pts) + torch.as_tensor(t)[:, :, None, :]
    uv = pinhole.project(torch.as_tensor(CAMERA), pc) + torch.as_tensor(rng.normal(0, 0.2, pc.shape[:-1] + (2,)))
    obj = torch.as_tensor(np.broadcast_to(grid, (b, v) + grid.shape).copy())
    opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=40, epsilon=1e-9))

    before = pr.launches
    _, _, out_gpu, rms_gpu = intrinsics_facade_batch(
        obj.to(cuda_device), uv.to(cuda_device), opts=opts, two_phase=True
    )
    torch.cuda.synchronize()
    assert pr.launches == before + 1  # the QA recheck went through the kernel
    _, _, out_cpu, rms_cpu = intrinsics_facade_batch(obj, uv, opts=opts, two_phase=True)
    assert bool(out_gpu[0].success.all())
    assert torch.equal(out_gpu[0].linearizations.cpu(), out_cpu[0].linearizations)
    rel = ((out_gpu[0].cost.cpu() - out_cpu[0].cost).abs() / out_cpu[0].cost).max()
    assert float(rel) <= 1e-7
    assert float((rms_gpu.cpu() - rms_cpu).abs().max()) <= ATOL_PX
