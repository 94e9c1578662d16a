from . import batched
from .batched import (
    bundle_batch,
    extrinsics_batch,
    handeye_batch,
    homography_batch,
    intrinsics_batch,
    intrinsics_facade_batch,
    linescan_batch,
    linescan_ransac_batch,
    planar_pose_batch,
    reprojection_rms_batch,
)

__all__ = [
    "batched", "bundle_batch", "extrinsics_batch", "handeye_batch", "homography_batch", "intrinsics_batch",
    "intrinsics_facade_batch", "linescan_batch", "linescan_ransac_batch", "planar_pose_batch",
    "reprojection_rms_batch",
]
