from . import blocks, core, extrinsics, intrinsics, lm, lm_schur, manifold
from .core import OptimOptions, OptimResult, OptimizerType, TerminationType
from .extrinsics import (
    ExtrinsicOptimizationResult,
    ExtrinsicOptions,
    optimize_extrinsics,
    optimize_extrinsics_device,
)
from .intrinsics import (
    IntrinsicsOptimizationResult,
    IntrinsicsOptimOptions,
    intrinsics_covariance_device,
    optimize_intrinsics,
    optimize_intrinsics_device,
)
from .lm import LMOutput, covariance_from_tangent
from .lm_schur import SchurOutput, lm_core_schur, tangent_covariance
from .manifold import ProductManifold, euclid, quat

__all__ = [
    "blocks", "core", "extrinsics", "intrinsics", "lm", "lm_schur", "manifold",
    "OptimOptions", "OptimResult", "OptimizerType", "TerminationType",
    "ExtrinsicOptions", "ExtrinsicOptimizationResult", "optimize_extrinsics",
    "optimize_extrinsics_device",
    "IntrinsicsOptimOptions", "IntrinsicsOptimizationResult", "intrinsics_covariance_device",
    "optimize_intrinsics", "optimize_intrinsics_device",
    "LMOutput", "covariance_from_tangent",
    "SchurOutput", "lm_core_schur", "tangent_covariance",
    "ProductManifold", "euclid", "quat",
]
