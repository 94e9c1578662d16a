"""Parameter-vector packing helpers (port of
``calibration_tpu/optim/blocks.py``), batched over leading dims.

The flat ambient layout is intrinsics, then all quaternions, then all
translations, so covariance matrices line up with the reference's.
"""

from __future__ import annotations

import torch

from ..ops import se3


def poses_to_quat_tran(poses):
    """(..., V, 4, 4) -> ((..., V, 4) wxyz quats, (..., V, 3) translations)."""
    return se3.rotmat_to_quat(poses[..., :3, :3]), poses[..., :3, 3]


def quat_tran_to_poses(quats, trans):
    return se3.make_se3(se3.quat_to_rotmat(quats), trans)


def pack_intr_quats_trans(intr, quats, trans):
    """(..., pc), (..., V, 4), (..., V, 3) -> (..., pc + 7V)."""
    lead = intr.shape[:-1]
    return torch.cat([intr, quats.reshape(lead + (-1,)), trans.reshape(lead + (-1,))], dim=-1)


def unpack_intr_quats_trans(x, pc, v):
    """(..., pc + 7V) -> ((..., pc), (..., V, 4), (..., V, 3))."""
    lead = x.shape[:-1]
    intr, quats, trans = torch.split(x, [pc, 4 * v, 3 * v], dim=-1)
    return intr, quats.reshape(lead + (v, 4)), trans.reshape(lead + (v, 3))
