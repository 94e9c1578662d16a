"""Native (C++) detections codec and JSON writer (port of
``calibration_tpu/native/__init__.py``).

The C++ sources, ``dataset_codec.cpp`` and ``fastjson.cpp`` beside this
module, are copies of the JAX package's (kept byte-identical by
``tests/test_torch_no_jax.py``). They build with g++ on first use into
``build/calibration_tpu_torch/native/<hash of source, flags and Python>/``
beside the package (never into the package directory), through the
kernels' build helper (``kernels/_build.py``).

- ``load_detections_packed`` parses a planar detections JSON payload into
  padded arrays without per-point Python objects (ctypes).
- ``dumps_fast`` writes JSON through a CPython extension, with output
  identical to ``json.dumps``.

Without a compiler both fall back as the JAX module does: ``available()``
is false and the loaders take the pure-Python path; ``dumps_fast`` uses
``json.dumps``.
"""

from __future__ import annotations

import ctypes
import importlib.machinery
import importlib.util
import json
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from ..kernels import _build as _kbuild
from ..utils import profiling

_ROOT = Path(__file__).resolve().parents[2]
_SRC_DIR = Path(__file__).resolve().parent
_BUILD_ROOT = _ROOT / "build" / "calibration_tpu_torch" / "native"
_GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False
_fj_mod = None
_fj_failed = False


def _build(src_name: str, out_name: str, extra_flags: tuple = (), key: str = "") -> Optional[Path]:
    """Compile ``<src_name>`` of this package unless the library for
    this source, these flags and ``key`` exists; None when g++ fails or is
    missing."""
    flags = _GXX_FLAGS + extra_flags
    src = _SRC_DIR / src_name
    try:
        return _kbuild.compile_once(
            "g++", flags, [src], _kbuild.cached_output(_BUILD_ROOT, out_name, flags, [src], key)
        )
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native codec; None when unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _build("dataset_codec.cpp", "_dataset_codec.so")
        try:
            lib = ctypes.CDLL(str(path)) if path is not None else None
        except OSError:
            lib = None
        if lib is None:
            _lib_failed = True
            return None
        lib.ctpu_parse_detections.restype = ctypes.c_void_p
        lib.ctpu_parse_detections.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        for name in ("ctpu_error", "ctpu_sensor_id", "ctpu_feature_type", "ctpu_header_json"):
            getattr(lib, name).restype = ctypes.c_char_p
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("ctpu_num_images", "ctpu_max_points", "ctpu_num_tags"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("ctpu_num_points", "ctpu_count_views"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int64]
        for name in ("ctpu_image_file", "ctpu_tag"):
            getattr(lib, name).restype = ctypes.c_char_p
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ctpu_pack.restype = ctypes.c_int64
        lib.ctpu_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ctpu_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _fastjson():
    """The fastjson extension module (built for this interpreter's headers
    and ABI), or None."""
    global _fj_mod, _fj_failed
    with _lock:
        if _fj_mod is not None or _fj_failed:
            return _fj_mod
        path = _build(
            "fastjson.cpp", "_fastjson.so", (f"-I{sysconfig.get_paths()['include']}",),
            key=str(sysconfig.get_config_var("EXT_SUFFIX")),
        )
        if path is None:
            _fj_failed = True
            return None
        try:
            loader = importlib.machinery.ExtensionFileLoader("_fastjson", str(path))
            spec = importlib.util.spec_from_file_location("_fastjson", str(path), loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
        except ImportError:
            _fj_failed = True
            return None
        _fj_mod = mod
        return _fj_mod


@profiling.traced("write")
def dumps_fast(obj, indent=None) -> str:
    """json.dumps-compatible serialization (ensure_ascii, default
    separators / indent=N) through the native writer; falls back to stdlib
    json on any unsupported input."""
    mod = _fastjson()
    if mod is not None:
        try:
            return mod.dumps(obj, indent=indent)
        except (TypeError, ValueError):
            pass
    return json.dumps(obj, indent=indent)


class PackedDetections(NamedTuple):
    sensor_id: str
    feature_type: str
    tags: List[str]
    files: List[str]
    obj_xy: np.ndarray  # (V, N, 2)
    img_uv: np.ndarray  # (V, N, 2)
    mask: np.ndarray  # (V, N) bool
    point_ids: np.ndarray  # (V, N) int64
    # top-level JSON object minus "images", re-emitted verbatim by the codec;
    # json.loads of this is O(header) instead of O(payload)
    header_json: str = "{}"


def load_detections_packed(
    source, min_points: int = 0, pad_to: Optional[int] = None
) -> PackedDetections:
    """Parse + pack a detections JSON payload natively.

    source: path or bytes/str JSON payload.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native dataset codec unavailable (no compiler?)")

    if isinstance(source, (str, Path)) and os.path.exists(str(source)):
        data = Path(source).read_bytes()
    elif isinstance(source, bytes):
        data = source
    else:
        data = str(source).encode()

    handle = lib.ctpu_parse_detections(data, len(data))
    try:
        err = lib.ctpu_error(handle).decode()
        if err:
            raise ValueError(f"native dataset codec: {err}")
        num_views = int(lib.ctpu_count_views(handle, min_points))
        n = int(lib.ctpu_max_points(handle))
        if pad_to is not None:
            n = max(n, pad_to)
        n = max(n, 1)
        obj = np.zeros((num_views, n, 2), np.float64)
        uv = np.zeros((num_views, n, 2), np.float64)
        mask = np.zeros((num_views, n), np.uint8)
        ids = np.zeros((num_views, n), np.int64)
        if num_views:
            wrote = lib.ctpu_pack(
                handle, min_points, n,
                obj.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                uv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
            if wrote != num_views:
                raise RuntimeError("native dataset codec: packing mismatch")
        files = [
            lib.ctpu_image_file(handle, i).decode()
            for i in range(int(lib.ctpu_num_images(handle)))
            if int(lib.ctpu_num_points(handle, i)) >= min_points
        ]
        tags = [lib.ctpu_tag(handle, i).decode() for i in range(int(lib.ctpu_num_tags(handle)))]
        return PackedDetections(
            sensor_id=lib.ctpu_sensor_id(handle).decode(),
            feature_type=lib.ctpu_feature_type(handle).decode(),
            tags=tags,
            files=files,
            obj_xy=obj,
            img_uv=uv,
            mask=mask.astype(bool),
            point_ids=ids,
            header_json=lib.ctpu_header_json(handle).decode(),
        )
    finally:
        lib.ctpu_free(handle)
