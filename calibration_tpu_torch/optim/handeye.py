"""AX = XB hand-eye refinement, batched over rigs (port of
``calibration_tpu/optim/handeye.py``).

Parameters: one quaternion + translation for X = gripper -> camera. Each
motion pair contributes a 6-vector residual, rotation then translation
(R_A - I) t_X - (R_X t_B - t_A), one Huber block per pair; filtered pairs
enter with weight 0. The rotation residual is the algebraic quaternion one
("quat", the default) or the reference's log map ("log"); both have
analytic tangent Jacobians, used by default, and the dense ``lm_core``
solves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import handeye_linear as hel
from ..ops import se3
from . import lm
from .core import OptimOptions, OptimResult, TerminationType, brief_report
from .manifold import ProductManifold, euclid, quat

_MANIFOLD = ProductManifold([quat(), euclid(3)])
OPTIMIZE_MIN_ANGLE_DEG = 0.5  # handeye.cpp:64


def _translation_rows(x, pairs: hel.MotionPairs, rot_x):
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    t = x[..., 4:7]
    return torch.einsum("...pij,...j->...pi", pairs.rot_a - eye, t) - (
        torch.einsum("...ij,...pj->...pi", rot_x, pairs.tra_b) - pairs.tra_a
    )


def _flat(r_rot, r_tra, weight):
    r = torch.cat([r_rot, r_tra], dim=-1) * weight[..., None]
    return r.reshape(r.shape[:-2] + (-1,))


def _residual(x, pairs: hel.MotionPairs):
    """Log-map residual (B, 6P): rot log(R_A R_X R_B^T R_X^T)."""
    rot_x = se3.quat_to_rotmat(x[..., :4])[..., None, :, :]
    rot_s = pairs.rot_a @ rot_x @ pairs.rot_b.transpose(-1, -2) @ rot_x.transpose(-1, -2)
    return _flat(se3.log_so3(rot_s), _translation_rows(x, pairs, rot_x[..., 0, :, :]), pairs.weight)


def _quat_error(q, q_a, q_b):
    """q_err = q_A (x) q_X (x) conj(q_B) (x) conj(q_X), per pair."""
    qx = q[..., None, :]
    return se3.quat_mul(se3.quat_mul(se3.quat_mul(q_a, qx), se3.quat_conj(q_b)), se3.quat_conj(qx))


def _residual_quat(x, pairs: hel.MotionPairs, q_a, q_b):
    """Algebraic residual (B, 6P): r_rot = 2 sgn(w) vec(q_err), the
    quaternion of the same error rotation the log residual measures; its
    zero set and first-order behavior equal the log residual's. sgn is +1
    where w >= 0 (an exact 0 included), as in the reference."""
    q_err = _quat_error(x[..., :4], q_a, q_b)
    sgn = torch.where(q_err[..., :1] < 0.0, -1.0, 1.0).to(x.dtype)
    rot_x = se3.quat_to_rotmat(x[..., :4])
    return _flat(2.0 * sgn * q_err[..., 1:4], _translation_rows(x, pairs, rot_x), pairs.weight)


def _qmat_l(q):
    """Left-multiplication matrix: quat_mul(q, p) == _qmat_l(q) @ p."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([w, -x, -y, -z], -1),
            torch.stack([x, w, -z, y], -1),
            torch.stack([y, z, w, -x], -1),
            torch.stack([z, -y, x, w], -1),
        ],
        dim=-2,
    )


def _qmat_r(q):
    """Right-multiplication matrix: quat_mul(p, q) == _qmat_r(q) @ p."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([w, -x, -y, -z], -1),
            torch.stack([x, w, z, -y], -1),
            torch.stack([y, -z, w, x], -1),
            torch.stack([z, y, -x, w], -1),
        ],
        dim=-2,
    )


def _jacobian(j_rot_w, x, pairs: hel.MotionPairs, rot_x):
    """Assemble (B, 6P, 6), columns [omega (3), dt (3)], from the rotation
    rows' omega block; translation rows d/dw = R_X [t_B]_x, d/dt = R_A - I."""
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    j_tra_w = torch.einsum("...ij,...pjk->...pik", rot_x, se3.skew(pairs.tra_b))
    top = torch.cat([j_rot_w, torch.zeros_like(j_rot_w)], dim=-1)
    bot = torch.cat([j_tra_w, pairs.rot_a - eye], dim=-1)
    jac = torch.cat([top, bot], dim=-2) * pairs.weight[..., None, None]
    return jac.reshape(jac.shape[:-3] + (-1, 6))


def _residual_quat_jac(x, pairs: hel.MotionPairs, q_a, q_b):
    """Analytic tangent Jacobian of ``_residual_quat`` for the right
    multiplied retraction q_X -> q_X (x) exp_quat(omega). With u = q_A (x)
    q_X: d q_err = [L(u) R(conj(q_B) conj(q_X)) - L(u conj(q_B))
    R(conj(q_X))] (E/2) d omega, E = [0; I3], so J_rot = sgn * M[1:4, 1:4]."""
    q = x[..., :4]
    q_x_c = se3.quat_conj(q)[..., None, :]
    qb_c = se3.quat_conj(q_b)
    u = se3.quat_mul(q_a, q[..., None, :])
    u_qbc = se3.quat_mul(u, qb_c)
    q_err = se3.quat_mul(u_qbc, q_x_c)
    sgn = torch.where(q_err[..., 0] < 0.0, -1.0, 1.0).to(x.dtype)
    v1 = se3.quat_mul(qb_c, q_x_c)
    m = _qmat_l(u) @ _qmat_r(v1) - _qmat_l(u_qbc) @ _qmat_r(q_x_c)
    return _jacobian(sgn[..., None, None] * m[..., 1:4, 1:4], x, pairs, se3.quat_to_rotmat(q))


def _jl_inv(phi):
    """Inverse left Jacobian of SO(3) at rotation vector phi (..., 3):
    I - [phi]_x / 2 + c [phi]_x^2, c = 1/theta^2 - (1 + cos)/(2 theta sin),
    the series 1/12 + theta^2/720 below theta = 1e-4. theta_safe keeps the
    unused branch finite."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-300))
    small = theta < 1e-4
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    c = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / torch.where(small, torch.ones_like(theta2), theta2)
        - (1.0 + torch.cos(theta_safe)) / (2.0 * theta_safe * torch.sin(theta_safe)),
    )
    sk = se3.skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * sk + c[..., None, None] * (sk @ sk)


def _residual_jac(x, pairs: hel.MotionPairs):
    """Analytic tangent Jacobian of ``_residual``: the rotation rows are
    J_l^-1(log M) R_A R_X (I - R_B^T)."""
    rot_x = se3.quat_to_rotmat(x[..., :4])
    rx = rot_x[..., None, :, :]
    rot_bt = pairs.rot_b.transpose(-1, -2)
    r0 = se3.log_so3(pairs.rot_a @ rx @ rot_bt @ rx.transpose(-1, -2))
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    j_rot_w = _jl_inv(r0) @ (pairs.rot_a @ rx) @ (eye - rot_bt)
    return _jacobian(j_rot_w, x, pairs, rot_x)


def _residual_fns(rot_residual: str, analytic_jac: bool):
    """(residual_fn, jac_fn) taking (x, *pairs), the MotionPairs fields."""
    if rot_residual == "quat":
        def res(x, *p):
            return _residual_quat(x, hel.MotionPairs(*p), p[5], p[6])

        def jac(x, *p):
            return _residual_quat_jac(x, hel.MotionPairs(*p), p[5], p[6])
    elif rot_residual == "log":
        def res(x, *p):
            return _residual(x, hel.MotionPairs(*p))

        def jac(x, *p):
            return _residual_jac(x, hel.MotionPairs(*p))
    else:
        raise ValueError(f"unknown rot_residual '{rot_residual}' (quat|log)")
    return res, (jac if analytic_jac else None)


def optimize_handeye_device(
    pairs: hel.MotionPairs,
    init_pose,
    options: OptimOptions = OptimOptions(),
    analytic_jac: bool = True,
    rot_residual: str = "quat",
):
    """Refine B rigs on the tensors' device. pairs: MotionPairs with a
    leading rig axis; init_pose: (B, 4, 4). Returns (LMOutput, X (B, 4, 4),
    cov (B, 7, 7), cov_ok (B,)). Covariance (on by default in
    OptimOptions) goes through the dense ``covariance``."""
    x0 = torch.cat([se3.rotmat_to_quat(se3.rot(init_pose)), se3.tra(init_pose)], dim=-1)
    p = pairs.rot_a.shape[-3]
    block_ids = np.repeat(np.arange(p), 6)
    res_fn, jac_fn = _residual_fns(rot_residual, analytic_jac)
    data = tuple(pairs)
    out = lm.lm_core(
        res_fn, x0, _MANIFOLD, data=data, options=options, block_ids=block_ids, num_blocks=p, jac_fn=jac_fn
    )
    if options.compute_covariance:
        cov, cov_ok = lm.covariance(
            res_fn, out.x, _MANIFOLD, data=data, block_ids=block_ids, num_blocks=p,
            huber_delta=options.huber_delta, jac_fn=jac_fn,
        )
    else:
        # callers that disable covariance do not pay the extra linearization
        b = x0.shape[0]
        cov = torch.zeros((b, 7, 7), dtype=x0.dtype, device=x0.device)
        cov_ok = torch.zeros((b,), dtype=torch.bool, device=x0.device)
    pose = se3.make_se3(se3.quat_to_rotmat(out.x[..., :4]), out.x[..., 4:7])
    return out, pose, cov, cov_ok


def estimate_and_optimize_handeye_device(
    base_se3_gripper, camera_se3_target, min_angle_deg: float = 1.0, options: OptimOptions = OptimOptions()
):
    """DLT seed, then the LM refine, for B rigs (handeye.cpp:80-87): the
    pairs are built once at ``min_angle_deg`` for the seed and reweighted
    at 0.5 deg for the refine (handeye.cpp:64-65). base_se3_gripper /
    camera_se3_target: (B, N, 4, 4). Returns the optimize_handeye_device
    tuple."""
    pairs = hel.build_all_pairs(base_se3_gripper, camera_se3_target, min_angle_deg)
    init_pose, _ = hel.estimate_handeye_dlt_pairs(pairs)
    return optimize_handeye_device(hel.reweight(pairs, OPTIMIZE_MIN_ANGLE_DEG), init_pose, options)


@dataclasses.dataclass
class HandeyeResult:
    core: OptimResult
    g_se3_c: np.ndarray  # (4, 4)


def _wrap_result(out, pose, cov, cov_ok, options) -> HandeyeResult:
    """One rig's result from host (numpy) slices of the device tuple."""
    core = OptimResult(
        success=bool(out.success),
        covariance=np.asarray(cov) if (options.compute_covariance and bool(cov_ok)) else None,
        final_cost=float(out.cost),
        iterations=int(out.iterations),
        termination=TerminationType(int(out.termination)),
        initial_cost=float(out.initial_cost),
    )
    core.report = brief_report(core)
    return HandeyeResult(core=core, g_se3_c=np.asarray(pose))


def _wrap_first(device_out, options) -> HandeyeResult:
    out, pose, cov, cov_ok = device_out
    host = lm.LMOutput(*(t[0].cpu().numpy() for t in out))
    return _wrap_result(host, pose[0].cpu().numpy(), cov[0].cpu().numpy(), bool(cov_ok[0]), options)


def optimize_handeye(
    base_se3_gripper, camera_se3_target, init_pose, options: OptimOptions = OptimOptions(),
    analytic_jac: bool = True, rot_residual: str = "quat",
) -> HandeyeResult:
    """optimize_handeye (handeye.cpp:60-78) for ONE rig: pairs rebuilt at
    0.5 deg, refined from init_pose. base_se3_gripper/camera_se3_target:
    (N, 4, 4); init_pose (4, 4); all tensors on one device."""
    pairs = hel.build_all_pairs(base_se3_gripper[None], camera_se3_target[None], OPTIMIZE_MIN_ANGLE_DEG)
    return _wrap_first(
        optimize_handeye_device(pairs, init_pose[None], options, analytic_jac=analytic_jac, rot_residual=rot_residual),
        options,
    )


def estimate_and_optimize_handeye(
    base_se3_gripper, camera_se3_target, min_angle_deg: float = 1.0, options: OptimOptions = OptimOptions()
) -> HandeyeResult:
    """DLT seed -> LM refine for ONE rig (handeye.cpp:80-87), a B = 1 call
    of ``estimate_and_optimize_handeye_device``."""
    return _wrap_first(
        estimate_and_optimize_handeye_device(base_se3_gripper[None], camera_se3_target[None], min_angle_deg, options),
        options,
    )
