from . import camera_matrix, distortion, pinhole, registry
from .camera_matrix import CalibrationBounds, sanitize_intrinsics
from .registry import PINHOLE, CameraModelSpec

__all__ = [
    "camera_matrix",
    "distortion",
    "pinhole",
    "registry",
    "CalibrationBounds",
    "sanitize_intrinsics",
    "CameraModelSpec",
    "PINHOLE",
]
