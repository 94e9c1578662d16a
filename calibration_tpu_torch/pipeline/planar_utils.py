"""Stage-internal helpers (reference: src/pipeline/detail/planar_utils.{h,cpp}).

A copy of ``calibration_tpu/pipeline/planar_utils.py``, which is JAX-free
but cannot be imported without importing JAX (``calibration_tpu/__init__.py``
imports it).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .dataset import PlanarDetections, PlanarImageDetections


def find_camera_config(cfg, camera_id: str):
    """planar_utils.cpp:9-15."""
    for cam in cfg.cameras:
        if cam.camera_id == camera_id:
            return cam
    return None


def find_handeye_rig(cfg, rig_id: str):
    """planar_utils.cpp:75-81."""
    for rig in cfg.rigs:
        if rig.rig_id == rig_id:
            return rig
    return None


class SensorDetectionsIndex:
    """sensor_id -> image-file -> detections lookup (planar_utils.cpp:37-52)."""

    def __init__(self, detections: PlanarDetections):
        self.detections = detections
        self.image_lookup: Dict[str, PlanarImageDetections] = {
            img.file: img for img in detections.images
        }


def build_sensor_index(detections: List[PlanarDetections]) -> Dict[str, SensorDetectionsIndex]:
    index: Dict[str, SensorDetectionsIndex] = {}
    for det in detections:
        if det.sensor_id:
            index[det.sensor_id] = SensorDetectionsIndex(det)
    return index


def make_planar_arrays(image: PlanarImageDetections) -> Tuple[np.ndarray, np.ndarray]:
    """Detections -> (obj_xy (N,2), img_uv (N,2)) — the array equivalent of
    make_planar_view (planar_utils.cpp:54-61): local_x/local_y are object
    plane coords, x/y the pixel measurements."""
    return image.arrays()


_VIEW_BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64)


def bucket_views(v: int) -> int:
    """Round a view count up to a small set of buckets. Here (no compiled
    programs to reuse) the buckets decide which sensors share one batched
    solve in ``calibrate_many``; padded views and points are masked or
    frozen, so no result depends on them."""
    for b in _VIEW_BUCKETS:
        if v <= b:
            return b
    return ((v + 15) // 16) * 16


def bucket_points(n: int, quantum: int = 32) -> int:
    """Round a per-view point count up to a multiple of ``quantum``."""
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def pad_views(
    views: List[Tuple[np.ndarray, np.ndarray]], pad_to: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ragged [(obj, uv)] -> padded (V, N, 2) x2 + mask (V, N)."""
    if not views:
        return np.zeros((0, 0, 2)), np.zeros((0, 0, 2)), np.zeros((0, 0), bool)
    n = max(o.shape[0] for o, _ in views)
    if pad_to is not None:
        n = max(n, pad_to)
    v = len(views)
    obj = np.zeros((v, n, 2))
    uv = np.zeros((v, n, 2))
    mask = np.zeros((v, n), bool)
    for i, (o, u) in enumerate(views):
        k = o.shape[0]
        obj[i, :k] = o
        uv[i, :k] = u
        mask[i, :k] = True
    return obj, uv, mask
