"""Multi-camera extrinsics initialisation via planar-pose averaging (port
of ``calibration_tpu/ops/extrinsics_linear.py``).

The reference vmaps over (view, camera) and over rigs; here every
function takes leading batch dims and runs once over all of them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import planarpose, se3


class ExtrinsicPoses(NamedTuple):
    c_se3_r: torch.Tensor  # (..., C, 4, 4) reference -> camera
    r_se3_t: torch.Tensor  # (..., V, 4, 4) target -> reference


def estimate_extrinsic_dlt(obj_xy, norm_uv, mask=None):
    """Per-(view, camera) planar pose -> camera poses relative to camera 0
    averaged over views -> per-view target poses averaged over cameras.

    obj_xy/norm_uv: (..., V, C, N, 2), image coords already normalized by
    each camera's K. mask: optional (..., V, C, N). A (view, camera) pair
    with fewer than 4 points gives a NaN pose that both averages select
    away (``se3.average_isometries``).
    """
    if mask is None:
        mask = torch.ones(obj_xy.shape[:-1], dtype=torch.bool, device=obj_xy.device)
    valid = torch.sum(mask.to(obj_xy.dtype), dim=-1) >= 4  # (..., V, C)
    cam_se3_ref = planarpose.estimate_planar_pose_normalized(obj_xy, norm_uv, mask)  # (..., V, C, 4, 4)

    # camera poses relative to camera 0, averaged over views
    rels = cam_se3_ref @ se3.se3_inverse(cam_se3_ref[..., 0:1, :, :])
    rel_w = (valid & valid[..., 0:1]).to(obj_xy.dtype)
    c_se3_r = se3.average_isometries(rels.transpose(-4, -3), rel_w.transpose(-1, -2))  # (..., C, 4, 4)
    c_se3_r[..., 0, :, :] = torch.eye(4, dtype=obj_xy.dtype, device=obj_xy.device)

    # per-view target poses, averaged over cameras
    tposes = se3.se3_inverse(c_se3_r)[..., None, :, :, :] @ cam_se3_ref  # (..., V, C, 4, 4)
    r_se3_t = se3.average_isometries(tposes, valid.to(obj_xy.dtype))
    return ExtrinsicPoses(c_se3_r, r_se3_t)
