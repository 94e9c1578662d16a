"""The part of ``calibration_tpu/optim/lm.py`` the planar-intrinsics slice
uses: the LM output record, the damping constants and the ambient lift of a
tangent covariance. The dense ``lm_core`` engine is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .manifold import ProductManifold

# Initial Nielsen damping for the Jacobi-scaled system (diag ~ 1, so this is
# tau directly): the reference's measured default, fixed here (the
# reference's CALIB_LM_MU_INIT override is not ported).
_MU_INIT = 1e-6
_MU_MIN = 1e-32
_MU_MAX = 1e32


class LMOutput(NamedTuple):
    """Batched: every field has a leading problem axis."""

    x: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor  # trials: accepted steps + rejected re-solves
    termination: torch.Tensor  # 0 no-conv, 1 ftol, 2 gtol, 3 xtol, 4 failure
    success: torch.Tensor
    linearizations: torch.Tensor  # residual + Jacobian evaluations


def covariance_from_tangent(c_t, x, manifold: ProductManifold, free_mask=None):
    """Lift a tangent covariance into ambient coordinates: C = D C_t D^T
    with D the retract Jacobian. c_t: (..., t, t); x: (..., a).
    Returns (cov (..., a, a), ok (...,))."""
    if free_mask is not None:
        tan_free = manifold.ambient_to_tangent_mask(free_mask).to(x.dtype)
        c_t = c_t * tan_free[..., :, None] * tan_free[..., None, :]
    d = manifold.lift_jacobian(x)
    cov = d @ c_t @ d.transpose(-1, -2)
    return cov, torch.isfinite(cov).all(dim=-1).all(dim=-1)
