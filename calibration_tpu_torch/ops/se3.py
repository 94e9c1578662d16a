"""SO(3)/SE(3) utilities (port of ``calibration_tpu/ops/se3.py``, the part
the planar-intrinsics, extrinsics and hand-eye slices use).

Poses are 4x4 homogeneous matrices, rotations 3x3 matrices, quaternions
(w, x, y, z). Everything broadcasts over leading batch dimensions. The
reference's accurate-trig workaround (``ops/fmath.py``) is not needed:
``torch.sin``/``cos`` are accurate on every backend.
"""

from __future__ import annotations

import torch

from . import linalg

_EPS = 1e-12


def skew(v):
    """Skew-symmetric matrix [v]_x; v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def project_to_so3(m):
    """Closest rotation via SVD polar decomposition."""
    u, _, vt = linalg.svd(m)
    det = linalg.det3(u @ vt)
    d = torch.ones(m.shape[:-2] + (3,), dtype=m.dtype, device=m.device)
    d[..., 2] = torch.sign(torch.where(det == 0, torch.ones_like(det), det))
    return (u * d[..., None, :]) @ vt


def exp_so3(w):
    """Rodrigues exp map, Taylor-safe near zero."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-16
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    k = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def rotmat_to_quat(r):
    """Rotation matrix -> unit quaternion (w, x, y, z), branchless: the
    four-candidate construction selecting the largest denominator."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)

    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.take_along_dim(cands, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q):
    """Quaternion (w, x, y, z) -> rotation matrix; normalizes the input."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def quat_conj(q):
    """Quaternion conjugate (w, x, y, z) -> (w, -x, -y, -z). (No sign
    vector built on the host: a host-to-device copy cannot be captured in a
    CUDA graph.)"""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a, b):
    """Hamilton product of (w, x, y, z) quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def log_so3(r):
    """SO(3) log map -> axis-angle 3-vector, by the quaternion route:
    differentiable at the identity (Taylor branch) and defined near pi."""
    q = rotmat_to_quat(r)
    sgn = torch.where(q[..., 0] < 0, -1.0, 1.0).to(r.dtype)  # angle in [0, pi]
    w = q[..., 0] * sgn
    v = q[..., 1:] * sgn[..., None]
    s2 = torch.sum(v * v, dim=-1)
    small = s2 < 1e-16
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    angle = 2.0 * torch.atan2(s, w)
    # factor = angle / s; Taylor: 2/w * (1 - s^2/(3 w^2))
    taylor = 2.0 / torch.clamp(w, min=_EPS) * (1.0 - s2 / (3.0 * torch.clamp(w * w, min=_EPS)))
    return v * torch.where(small, taylor, angle / s)[..., None]


def exp_quat(w):
    """Axis-angle 3-vector -> unit quaternion (w, x, y, z), Taylor-safe."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-16
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    sinc_half = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([cw[..., None], w * sinc_half[..., None]], dim=-1)


def make_se3(r, t):
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=r.dtype, device=r.device)
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def se3_identity(dtype=torch.float64, *, device):
    return torch.eye(4, dtype=dtype, device=device)


def rot(m):
    return m[..., :3, :3]


def tra(m):
    return m[..., :3, 3]


def se3_inverse(m):
    rt = m[..., :3, :3].transpose(-1, -2)
    return make_se3(rt, -(rt @ m[..., :3, 3:4])[..., 0])


def se3_apply(m, p):
    """Apply poses to points p: (..., 3)."""
    return torch.einsum("...ij,...j->...i", rot(m), p) + tra(m)


def se3_exp(w6):
    """The pose6 packing (omega, t) -> SE(3): rotation exp, translation
    stored directly."""
    return make_se3(exp_so3(w6[..., :3]), w6[..., 3:])


def se3_log(m):
    """SE(3) -> pose6 (omega, t), the inverse of ``se3_exp``."""
    return torch.cat([log_so3(rot(m)), tra(m)], dim=-1)


def average_isometries(poses, mask=None):
    """Quaternion sign-aligned average of SE(3) poses over the K axis.

    poses: (..., K, 4, 4); mask: optional (..., K) validity weights.
    Quaternions are sign-aligned against the first valid pose. A masked-out
    pose is selected away, not only weighted: it may be NaN (a degenerate
    view), and NaN * 0 is NaN. No valid pose gives the identity rotation
    and a zero translation.
    """
    q = rotmat_to_quat(poses[..., :3, :3])
    t = poses[..., :3, 3]
    if mask is None:
        mask = torch.ones(poses.shape[:-2], dtype=poses.dtype, device=poses.device)
    mask = mask.to(poses.dtype)
    ident = torch.zeros(4, dtype=poses.dtype, device=poses.device)
    ident[0] = 1.0
    valid = (mask > 0)[..., None]
    q = torch.where(valid, q, ident)
    t = torch.where(valid, t, torch.zeros_like(t))
    denom = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    ref_idx = torch.argmax(mask, dim=-1)  # the first valid pose
    q_ref = torch.take_along_dim(q, ref_idx[..., None, None], dim=-2)
    sgn = torch.where(torch.sum(q * q_ref, dim=-1) < 0, -1.0, 1.0).to(poses.dtype)
    q_sum = torch.sum(q * (sgn * mask)[..., None], dim=-2)
    nrm = torch.linalg.norm(q_sum, dim=-1, keepdim=True)
    q_avg = torch.where(nrm > _EPS, q_sum / torch.clamp(nrm, min=_EPS), ident)
    t_avg = torch.sum(t * mask[..., None], dim=-2) / denom[..., None]
    return make_se3(quat_to_rotmat(q_avg), t_avg)


def pose_to_array(m):
    """SE(3) -> pose6 [axis-angle, t]."""
    return se3_log(m)


def array_to_pose(p6):
    return se3_exp(p6)
