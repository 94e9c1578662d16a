"""Device meshes for calibration problem batches (port of
``calibration_tpu/parallel/sharding.py``).

The problems of a batch are independent, so the batch is split across
devices by data parallelism: its leading axis is padded to a multiple of
the mesh size, cut into equal chunks, chunk i is solved on the mesh's
i-th device, and only the gather of the results crosses devices. No solve
needs a collective.

A ``Mesh`` is a tuple of torch devices. ``make_mesh()`` takes every
visible CUDA device and raises when there is none: it never falls back to
the CPU. A CPU mesh exists only when the caller names CPU devices. A
device may appear more than once: torch has one CPU device, so
``make_mesh(["cpu"] * 4)`` stands in for the reference's 8-device virtual
CPU mesh in the tests, and ``make_mesh(["cuda:0"] * 4)`` runs the pad,
split and gather path of four shards on one card.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[i]`` solves shard i of a batch."""

    devices: tuple  # of torch.device
    axis_name: str = BATCH_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over every visible CUDA device, or over ``devices`` (torch
    devices or their names; repeats allowed, see the module docstring)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is visible; name the mesh's devices to use others")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devices, axis_name)


def mesh_devices(n_devices: Optional[int] = None, probe: bool = False):
    """The first ``n_devices`` visible CUDA devices (every one when None),
    or None when fewer are visible. With ``probe`` each chosen device
    first takes a one-element copy, which raises if the device does not
    work. There is no CPU fallback."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = n_devices or 1
    if count < want:
        return None
    chosen = [torch.device("cuda", i) for i in range(n_devices or count)]
    if probe:
        for d in chosen:
            torch.zeros((1,)).to(d)
            torch.cuda.synchronize(d)
    return chosen


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Splits a leaf's leading (problem) axis over ``mesh``: chunk i to
    ``mesh.devices[i]``. A leaf whose leading axis does not divide the mesh
    is replicated to every device; a leaf that is not a tensor goes to every
    shard as it is."""

    mesh: Mesh
    axis_name: str = BATCH_AXIS

    def place(self, x) -> list:
        """The leaf's value on each shard, in mesh order."""
        devices = self.mesh.devices
        n = len(devices)
        if isinstance(x, np.ndarray):
            x = torch.as_tensor(x)
        if not isinstance(x, torch.Tensor):
            return [x] * n
        if x.dim() >= 1 and x.shape[0] % n == 0:
            return [c.to(d) for c, d in zip(torch.tensor_split(x, n), devices)]
        if n > 1 and x.dim() >= 1 and x.shape[0] > n:
            # a batch-like leaf that does not divide the mesh: every shard
            # would solve the whole batch, so tell the caller to pad
            warnings.warn(
                f"shard_batch: leading axis {x.shape[0]} does not divide the {n}-device mesh; the leaf is "
                f"REPLICATED. Pad the batch first with parallel.pad_batch.",
                stacklevel=3,
            )
        return [x.to(d) for d in devices]


def batch_sharding(mesh: Mesh, axis_name: str = BATCH_AXIS) -> BatchSharding:
    """Shard the leading (problem) axis; replicate everything after it."""
    return BatchSharding(mesh, axis_name)


def shard_batch(tree, mesh: Mesh, axis_name: str = BATCH_AXIS) -> list:
    """One copy of ``tree`` per mesh device, each leaf placed by
    ``batch_sharding``: a list of ``mesh.size`` trees."""
    leaves, spec = pytree.tree_flatten(tree)
    placed = [batch_sharding(mesh, axis_name).place(x) for x in leaves]
    return [pytree.tree_unflatten([p[i] for p in placed], spec) for i in range(mesh.size)]


def pad_batch(tree, multiple: int):
    """Pad the leading axis of every leaf up to a multiple of ``multiple``
    with copies of problem 0, so the batch divides the mesh. The batch size
    is the first leaf's leading axis; leaves with another leading axis (or
    none) are left as they are. Returns (padded_tree, real_count)."""
    leaves, spec = pytree.tree_flatten(tree)
    arrays = [x for x in leaves if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1]
    b = arrays[0].shape[0]
    target = -(-b // multiple) * multiple
    if target == b:
        return tree, b
    reps = np.concatenate([np.arange(b), np.zeros(target - b, np.int64)])

    def pad(x):
        if not (isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1 and x.shape[0] == b):
            return x
        if isinstance(x, np.ndarray):
            return x[reps]
        return x[torch.as_tensor(reps, device=x.device)]

    return pytree.tree_unflatten([pad(x) for x in leaves], spec), b
