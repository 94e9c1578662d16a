"""Tsai-Lenz hand-eye DLT from motion pairs, batched over rigs (port of
``calibration_tpu/ops/handeye_linear.py``).

Every tensor may carry leading rig dimensions. The reference's
data-dependent pair filtering (minimum rotation angle, near-parallel axes)
is a weight per pair over the static all-pairs set, so the stacked 3P x 3
ridge solves keep fixed shapes. Pairs are built from pose quaternions: the
relative rotation A_ij = R_i^T R_j is conj(q_i) (x) q_j, renormalized with
w >= 0 (its projection to SO(3)); the angle filter compares |vec(q)| =
sin(theta/2) with a threshold; the modified Rodrigues vector of the exact
Tsai-Lenz relation is 2 vec(q).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import linalg, se3


class MotionPairs(NamedTuple):
    rot_a: torch.Tensor  # (..., P, 3, 3)
    rot_b: torch.Tensor  # (..., P, 3, 3)
    tra_a: torch.Tensor  # (..., P, 3)
    tra_b: torch.Tensor  # (..., P, 3)
    weight: torch.Tensor  # (..., P) 1.0 for pairs that pass the filters
    # unit pair quaternions with w >= 0 (rot_a == quat_to_rotmat(q_a))
    q_a: torch.Tensor  # (..., P, 4)
    q_b: torch.Tensor  # (..., P, 4)


def pair_indices(n: int, device=None):
    """All pairs (i, j) with i < j, in row-major order (handeyedlt.cpp:63-75)."""
    ii, jj = torch.triu_indices(n, n, 1, device=device)
    return ii, jj


def _canonical(q):
    """Normalize and fix the double cover (w >= 0): the quaternion route's
    projection to SO(3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0).to(q.dtype)


def pair_weights(q_a, q_b, min_angle_deg: float, reject_axis_parallel: bool = True, axis_parallel_eps: float = 1e-3):
    """Filter flags from pair quaternions (handeyedlt.cpp:63-75 semantics):
    theta >= theta_min <=> |vec(q)| >= sin(theta_min / 2) for canonical q;
    axis-parallel pairs by the cross product of the normalized vector parts."""
    vec_a, vec_b = q_a[..., 1:4], q_b[..., 1:4]
    sin_half_a = torch.linalg.norm(vec_a, dim=-1)
    sin_half_b = torch.linalg.norm(vec_b, dim=-1)
    thresh = math.sin(0.5 * math.radians(min_angle_deg))
    good = torch.minimum(sin_half_a, sin_half_b) >= thresh
    if reject_axis_parallel:
        an = vec_a / torch.clamp(sin_half_a, min=1e-12)[..., None]
        bn = vec_b / torch.clamp(sin_half_b, min=1e-12)[..., None]
        sin_axis = torch.linalg.norm(torch.linalg.cross(an, bn, dim=-1), dim=-1)
        # both rotating: theta >= 1e-9 rad <=> sin(theta/2) >= 5e-10
        both_rotating = (sin_half_a >= 5e-10) & (sin_half_b >= 5e-10)
        good = good & (~both_rotating | (sin_axis >= axis_parallel_eps))
    return good


def build_all_pairs(
    base_se3_gripper,
    cam_se3_target,
    min_angle_deg: float = 1.0,
    reject_axis_parallel: bool = True,
    axis_parallel_eps: float = 1e-3,
    pose_mask=None,
) -> MotionPairs:
    """Motion pairs with filter weights (handeyedlt.cpp:11-81).
    base_se3_gripper/cam_se3_target: (..., N, 4, 4); pose_mask: optional
    (..., N) bool."""
    n = base_se3_gripper.shape[-3]
    ii, jj = pair_indices(n, base_se3_gripper.device)
    rot_bg, tra_bg = se3.rot(base_se3_gripper), se3.tra(base_se3_gripper)
    rot_ct, tra_ct = se3.rot(cam_se3_target), se3.tra(cam_se3_target)
    q_bg = se3.rotmat_to_quat(rot_bg)  # N conversions, not P
    q_ct = se3.rotmat_to_quat(rot_ct)

    # A_ij = inv(a_i) a_j (gripper motion); B_ij = b_i inv(b_j) (camera motion)
    q_a = _canonical(se3.quat_mul(se3.quat_conj(q_bg[..., ii, :]), q_bg[..., jj, :]))
    q_b = _canonical(se3.quat_mul(q_ct[..., ii, :], se3.quat_conj(q_ct[..., jj, :])))
    rot_a = se3.quat_to_rotmat(q_a)
    rot_b = se3.quat_to_rotmat(q_b)
    tra_a = torch.einsum("...pji,...pj->...pi", rot_bg[..., ii, :, :], tra_bg[..., jj, :] - tra_bg[..., ii, :])
    tra_b = tra_ct[..., ii, :] - torch.einsum("...pij,...pj->...pi", rot_b, tra_ct[..., jj, :])

    good = pair_weights(q_a, q_b, min_angle_deg, reject_axis_parallel, axis_parallel_eps)
    if pose_mask is not None:
        pose_mask = pose_mask.bool()
        good = good & pose_mask[..., ii] & pose_mask[..., jj]
    return MotionPairs(rot_a, rot_b, tra_a, tra_b, good.to(base_se3_gripper.dtype), q_a, q_b)


def reweight(pairs: MotionPairs, min_angle_deg: float, **kw) -> MotionPairs:
    """The same pairs under another angle threshold (the DLT seeds at the
    caller's min angle, the LM refines at 0.5 deg, handeye.cpp:64-65):
    weights recomputed from the stored quaternions, nothing rebuilt."""
    good = pair_weights(pairs.q_a, pairs.q_b, min_angle_deg, **kw)
    return pairs._replace(weight=good.to(pairs.weight.dtype))


def _modified_rodrigues(rot):
    """2 sin(theta/2) * axis from a rotation matrix: the vector for which
    the Tsai-Lenz relation is exact. The matrix-input reference
    implementation; the pair path reads 2 vec(q) directly."""
    w = se3.log_so3(rot)
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-16
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    scale = torch.where(small, 1.0 - theta2 / 24.0, 2.0 * torch.sin(0.5 * theta) / theta)
    return w * scale[..., None]


def _stack_rows(m):
    """(..., P, 3, k) -> (..., 3P, k)."""
    return m.reshape(m.shape[:-3] + (-1, m.shape[-1]))


def estimate_rotation_allpairs(pairs: MotionPairs):
    """Exact Tsai-Lenz rotation: skew(Pa + Pb) x = Pb - Pa with modified
    Rodrigues vectors (Pa = 2 vec(q_a)); x = tan(theta_x/2) * axis_x."""
    pa = 2.0 * pairs.q_a[..., 1:4]
    pb = 2.0 * pairs.q_b[..., 1:4]
    m = se3.skew(pa + pb) * pairs.weight[..., None, None]
    d = (pb - pa) * pairs.weight[..., None]
    x = linalg.ridge_llsq(_stack_rows(m), _stack_rows(d[..., None])[..., 0], 1e-12)
    t2 = torch.sum(x * x, dim=-1)
    small = t2 < 1e-16
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    scale = torch.where(small, 2.0 * (1.0 - t2 / 3.0), 2.0 * torch.atan(t) / t)
    return se3.exp_so3(x * scale[..., None])


def estimate_translation_allpairs(pairs: MotionPairs, rot_x):
    """(R_A - I) t = R_X t_B - t_A, stacked ridge LSQ (handeyedlt.cpp:102-119)."""
    eye = torch.eye(3, dtype=rot_x.dtype, device=rot_x.device)
    c = (pairs.rot_a - eye) * pairs.weight[..., None, None]
    w = (torch.einsum("...ij,...pj->...pi", rot_x, pairs.tra_b) - pairs.tra_a) * pairs.weight[..., None]
    return linalg.ridge_llsq(_stack_rows(c), _stack_rows(w[..., None])[..., 0], 1e-12)


def estimate_handeye_dlt_pairs(pairs: MotionPairs):
    """Tsai-Lenz linear init from built pairs. Returns (X (..., 4, 4), ok (...,))."""
    ok = torch.sum(pairs.weight, dim=-1) > 0
    rot_x = estimate_rotation_allpairs(pairs)
    tra_x = estimate_translation_allpairs(pairs, rot_x)
    return se3.make_se3(rot_x, tra_x), ok


def estimate_handeye_dlt(base_se3_gripper, cam_se3_target, min_angle_deg: float = 1.0, pose_mask=None):
    """Tsai-Lenz linear init (handeyedlt.cpp:122-133). Returns (X, ok)."""
    pairs = build_all_pairs(base_se3_gripper, cam_se3_target, min_angle_deg, pose_mask=pose_mask)
    return estimate_handeye_dlt_pairs(pairs)
