from . import batched, sharding
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
from .sharding import BATCH_AXIS, Mesh, batch_sharding, make_mesh, mesh_devices, pad_batch, shard_batch

__all__ = [
    "batched", "sharding", "bundle_batch", "extrinsics_batch", "handeye_batch", "homography_batch",
    "intrinsics_batch", "intrinsics_facade_batch", "linescan_batch", "linescan_ransac_batch", "planar_pose_batch",
    "reprojection_rms_batch", "BATCH_AXIS", "Mesh", "batch_sharding", "make_mesh", "mesh_devices", "pad_batch",
    "shard_batch",
]
