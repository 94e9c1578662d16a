from . import (
    blocks, bundle, core, extrinsics, handeye, homography, intrinsics, lm, lm_schur, manifold, planarpose, semidlt,
)
from .bundle import BundleOptions, BundleResult, optimize_bundle, optimize_bundle_device
from .core import OptimOptions, OptimResult, OptimizerType, TerminationType
from .extrinsics import (
    ExtrinsicOptimizationResult,
    ExtrinsicOptions,
    optimize_extrinsics,
    optimize_extrinsics_device,
)
from .handeye import (
    HandeyeResult,
    estimate_and_optimize_handeye,
    optimize_handeye,
    optimize_handeye_device,
)
from .homography import OptimizeHomographyResult, optimize_homography, optimize_homography_device
from .intrinsics import (
    IntrinsicsOptimizationResult,
    IntrinsicsOptimOptions,
    intrinsics_covariance_device,
    optimize_intrinsics,
    optimize_intrinsics_device,
)
from .lm import LMOutput, covariance, covariance_from_tangent, lm_core
from .lm_schur import SchurOutput, lm_core_schur, tangent_covariance
from .manifold import ProductManifold, euclid, quat
from .planarpose import PlanarPoseOptions, PlanarPoseResult, optimize_planar_pose, optimize_planar_pose_device
from .semidlt import SemiDltResult, optimize_intrinsics_semidlt, optimize_intrinsics_semidlt_device

__all__ = [
    "blocks", "bundle", "core", "extrinsics", "handeye", "homography", "intrinsics", "lm", "lm_schur", "manifold",
    "planarpose", "semidlt",
    "BundleOptions", "BundleResult", "optimize_bundle", "optimize_bundle_device",
    "OptimOptions", "OptimResult", "OptimizerType", "TerminationType",
    "ExtrinsicOptions", "ExtrinsicOptimizationResult", "optimize_extrinsics",
    "optimize_extrinsics_device",
    "HandeyeResult", "estimate_and_optimize_handeye", "optimize_handeye", "optimize_handeye_device",
    "OptimizeHomographyResult", "optimize_homography", "optimize_homography_device",
    "IntrinsicsOptimOptions", "IntrinsicsOptimizationResult", "intrinsics_covariance_device",
    "optimize_intrinsics", "optimize_intrinsics_device",
    "LMOutput", "covariance", "covariance_from_tangent", "lm_core",
    "SchurOutput", "lm_core_schur", "tangent_covariance",
    "ProductManifold", "euclid", "quat",
    "PlanarPoseOptions", "PlanarPoseResult", "optimize_planar_pose", "optimize_planar_pose_device",
    "SemiDltResult", "optimize_intrinsics_semidlt", "optimize_intrinsics_semidlt_device",
]
