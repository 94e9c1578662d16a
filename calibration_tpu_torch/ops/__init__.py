from . import (
    homography,
    intrinsics_linear,
    linalg,
    planarpose,
    projection_residuals,
    se3,
    zhang,
)

__all__ = [
    "homography",
    "intrinsics_linear",
    "linalg",
    "planarpose",
    "projection_residuals",
    "se3",
    "zhang",
]
