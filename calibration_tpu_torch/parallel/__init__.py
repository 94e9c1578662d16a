from . import batched
from .batched import intrinsics_batch, intrinsics_facade_batch, reprojection_rms_batch

__all__ = ["batched", "intrinsics_batch", "intrinsics_facade_batch", "reprojection_rms_batch"]
