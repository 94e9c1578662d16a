from . import (
    extrinsics_linear,
    handeye_linear,
    homography,
    intrinsics_linear,
    linalg,
    linescan,
    planarpose,
    planefit,
    projection_residuals,
    ransac,
    se3,
    zhang,
)

__all__ = [
    "extrinsics_linear",
    "handeye_linear",
    "homography",
    "intrinsics_linear",
    "linalg",
    "linescan",
    "planarpose",
    "planefit",
    "projection_residuals",
    "ransac",
    "se3",
    "zhang",
]
