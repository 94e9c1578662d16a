"""Camera model registry (port of ``calibration_tpu/models/registry.py``):
a model is a named bundle of functions over a flat parameter vector, and
the solvers are generic over it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import pinhole, scheimpflug


@dataclasses.dataclass(frozen=True)
class CameraModelSpec:
    name: str
    param_count: int
    idx_fx: int
    idx_fy: int
    idx_skew: int
    # start of the [k1, k2, k3, p1, p2] distortion vector in the flat packing
    idx_dist0: int
    project: Callable  # (intr, xyz[..., 3]) -> uv[..., 2]
    unproject: Callable  # (intr, uv[..., 2]) -> model-native xy[..., 2]
    apply_intrinsics: Callable  # pixel -> normalized
    remove_intrinsics: Callable  # normalized -> pixel
    # pixel -> z = 1 normalized camera-frame xy (ray / ray_z): ``unproject``
    # for pinhole; through the ray for tilted-sensor models
    unproject_normalized: Callable
    # the port's own field, after the reference's: whether the fleet's
    # float32 reprojection-RMS QA recheck runs for this model (its CUDA
    # kernel projects through the pinhole model; the reference skips the
    # recheck for every other model)
    qa_recheck: bool = False


PINHOLE = CameraModelSpec(
    name="pinhole_brown_conrady",
    param_count=pinhole.PARAM_COUNT,
    idx_fx=pinhole.IDX_FX,
    idx_fy=pinhole.IDX_FY,
    idx_skew=pinhole.IDX_SKEW,
    idx_dist0=pinhole.IDX_SKEW + 1,
    project=pinhole.project,
    unproject=pinhole.unproject,
    apply_intrinsics=pinhole.apply_intrinsics,
    remove_intrinsics=pinhole.remove_intrinsics,
    unproject_normalized=pinhole.unproject,
    qa_recheck=True,
)

SCHEIMPFLUG = CameraModelSpec(
    name="scheimpflug_pinhole_brown_conrady",
    param_count=scheimpflug.PARAM_COUNT,
    idx_fx=scheimpflug.IDX_FX,
    idx_fy=scheimpflug.IDX_FY,
    idx_skew=scheimpflug.IDX_SKEW,
    idx_dist0=scheimpflug.IDX_SKEW + 1,
    project=scheimpflug.project,
    unproject=scheimpflug.unproject,
    apply_intrinsics=scheimpflug.apply_intrinsics,
    remove_intrinsics=scheimpflug.remove_intrinsics,
    unproject_normalized=scheimpflug.unproject_normalized,
)

SPECS = (PINHOLE, SCHEIMPFLUG)
MODELS = {m.name: m for m in SPECS}
# short aliases used by configs
MODELS["pinhole"] = PINHOLE
MODELS["scheimpflug"] = SCHEIMPFLUG


def get_model(name: str) -> CameraModelSpec:
    try:
        return MODELS[name]
    except KeyError:
        raise KeyError(f"Unknown camera model '{name}'; known: {sorted(MODELS)}") from None
