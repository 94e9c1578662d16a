from . import camera_matrix, distortion, pinhole, registry, scheimpflug
from .camera_matrix import CalibrationBounds, sanitize_intrinsics
from .registry import PINHOLE, SCHEIMPFLUG, CameraModelSpec, get_model

__all__ = [
    "camera_matrix",
    "distortion",
    "pinhole",
    "registry",
    "scheimpflug",
    "CalibrationBounds",
    "sanitize_intrinsics",
    "CameraModelSpec",
    "PINHOLE",
    "SCHEIMPFLUG",
    "get_model",
]
