"""Dataset schema (reference: include/calib/pipeline/dataset.h,
schemas/calib_dataset.schema.json). Field names and JSON layout match the
reference so datasets are interchangeable.

Beyond the reference, ``PlanarDetections.packed()`` converts the ragged
per-image point lists into padded device arrays (obj_xy/img_uv/mask) — the
unit of work every batched estimator consumes.

A copy of ``calibration_tpu/pipeline/dataset.py``, which is JAX-free but cannot be
imported without importing JAX (``calibration_tpu/__init__.py`` imports it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class PlanarTargetPoint:
    """dataset.h:15-22."""

    x: float = 0.0
    y: float = 0.0
    id: int = -1
    local_x: float = 0.0
    local_y: float = 0.0
    local_z: float = 0.0


class _LazyPoints(list):
    """PlanarTargetPoint list materialized on first element access from
    array-backed storage (native loader fast path). Keeps the public
    ``image.points`` API exact while the hot paths read the arrays
    directly (num_points()/arrays()) and never build per-point objects."""

    def __init__(self, obj_xy, img_uv, point_ids):
        super().__init__()
        self._src = (obj_xy, img_uv, point_ids)

    def _fill(self):
        if self._src is not None:
            obj, uv, ids = self._src
            self._src = None
            super().extend(
                PlanarTargetPoint(
                    x=float(uv[i, 0]), y=float(uv[i, 1]),
                    id=-1 if ids is None else int(ids[i]),
                    local_x=float(obj[i, 0]), local_y=float(obj[i, 1]),
                )
                for i in range(obj.shape[0])
            )

    def __len__(self):
        self._fill()
        return super().__len__()

    def __iter__(self):
        self._fill()
        return super().__iter__()

    def __getitem__(self, i):
        self._fill()
        return super().__getitem__(i)

    def __bool__(self):
        if self._src is not None:
            return self._src[0].shape[0] > 0
        return super().__len__() > 0

    def __repr__(self):
        self._fill()
        return super().__repr__()

    def __eq__(self, other):
        self._fill()
        return list(self) == other

    __hash__ = None


@dataclasses.dataclass
class PlanarImageDetections:
    """dataset.h:24-27.

    Two storage forms share this type:
    - JSON/python form: ``points`` holds PlanarTargetPoint objects.
    - array-backed form (native loader fast path): plain instance
      attributes ``_obj_xy`` (N, 2), ``_img_uv`` (N, 2), ``_point_ids``
      (N,) hold the same data without per-point objects (93x faster to
      ingest), and ``points`` is a lazy view that materializes only if
      someone indexes/iterates it. The extra attributes are NOT dataclass
      fields, so the jsonio reflection and JSON layout are untouched.
    Hot-path consumers use ``num_points()`` / ``arrays()`` — exact on both
    forms, never materializing point objects.
    """

    file: str = ""
    points: List[PlanarTargetPoint] = dataclasses.field(default_factory=list)

    def set_arrays(self, obj_xy, img_uv, point_ids=None) -> None:
        self._obj_xy = np.ascontiguousarray(obj_xy, np.float64)
        self._img_uv = np.ascontiguousarray(img_uv, np.float64)
        self._point_ids = (
            None if point_ids is None else np.ascontiguousarray(point_ids, np.int64)
        )
        self.points = _LazyPoints(self._obj_xy, self._img_uv, self._point_ids)

    def num_points(self) -> int:
        a = getattr(self, "_obj_xy", None)
        return len(self.points) if a is None else int(a.shape[0])

    def arrays(self):
        """(obj_xy (N, 2), img_uv (N, 2)) — the array equivalent of
        make_planar_view (planar_utils.cpp:54-61): local_x/local_y are
        object plane coords, x/y the pixel measurements."""
        a = getattr(self, "_obj_xy", None)
        if a is not None:
            return a, self._img_uv
        n = len(self.points)
        obj = np.zeros((n, 2))
        uv = np.zeros((n, 2))
        for i, p in enumerate(self.points):
            obj[i] = (p.local_x, p.local_y)
            uv[i] = (p.x, p.y)
        return obj, uv


@dataclasses.dataclass
class PlanarDetections:
    """dataset.h:29-39."""

    image_directory: str = ""
    feature_type: str = ""
    algo_version: str = ""
    params_hash: str = ""
    sensor_id: str = ""
    tags: List[str] = dataclasses.field(default_factory=list)
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    source_file: str = ""
    images: List[PlanarImageDetections] = dataclasses.field(default_factory=list)

    def packed(self, min_points: int = 0, pad_to: Optional[int] = None):
        """Pack images with >= min_points detections into padded arrays.

        Returns (obj_xy (V, N, 2), img_uv (V, N, 2), mask (V, N),
        files list[str]). N = max point count (or pad_to).
        """
        imgs = [im for im in self.images if im.num_points() >= min_points]
        if not imgs:
            return (
                np.zeros((0, 0, 2)),
                np.zeros((0, 0, 2)),
                np.zeros((0, 0), bool),
                [],
            )
        n = max(im.num_points() for im in imgs)
        if pad_to is not None:
            n = max(n, pad_to)
        v = len(imgs)
        obj = np.zeros((v, n, 2))
        uv = np.zeros((v, n, 2))
        mask = np.zeros((v, n), bool)
        files = []
        for i, im in enumerate(imgs):
            o, u = im.arrays()
            k = o.shape[0]
            obj[i, :k] = o
            uv[i, :k] = u
            mask[i, :k] = True
            files.append(im.file)
        return obj, uv, mask, files


@dataclasses.dataclass
class CalibrationDataset:
    """dataset.h:44-49."""

    schema_version: int = 1
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    planar_cameras: List[PlanarDetections] = dataclasses.field(default_factory=list)
    raw_json: Dict[str, Any] = dataclasses.field(default_factory=dict)
