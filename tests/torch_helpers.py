"""Shared pieces of the PyTorch-port equivalence tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU in float64, the port on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import synth


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several pytest workers: keep each one's torch
    intra-op pool to one thread so they do not oversubscribe the host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def camera_views(b, v, rows=5, cols=7, pitch=0.04, noise=0.0, seed=5):
    """B cameras x V views of a planar grid: (obj (B, V, N, 2), uv, poses
    (B, V, 4, 4), intr_gt (10,)). Each camera sees a differently tilted
    circle of views, so lanes converge at different iterations."""
    rng = np.random.default_rng(seed)
    intr_gt = synth.default_camera()
    grid = synth.make_target_grid(rows, cols, pitch)
    poses = np.stack([synth.circle_views(v, tilt=0.22 + 0.03 * i) for i in range(b)])
    uv = np.stack([synth.render_pixels(intr_gt, poses[i], grid, noise=noise, rng=rng) for i in range(b)])
    obj = np.broadcast_to(grid, (b, v) + grid.shape).copy()
    return obj, uv, poses, intr_gt


def rel_fro(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))
