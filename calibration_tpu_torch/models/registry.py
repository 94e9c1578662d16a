"""Camera model registry (port of ``calibration_tpu/models/registry.py``).

Only the pinhole + Brown-Conrady model is ported so far; the spec carries
the fields the intrinsics solver reads. ``get_model`` knows the reference's
names: a Scheimpflug name raises ``NotImplementedError`` (not ported yet),
an unknown name ``KeyError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import pinhole


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


PINHOLE = CameraModelSpec(
    name="pinhole_brown_conrady",
    param_count=pinhole.PARAM_COUNT,
    idx_fx=pinhole.IDX_FX,
    idx_fy=pinhole.IDX_FY,
    idx_skew=pinhole.IDX_SKEW,
    idx_dist0=pinhole.IDX_SKEW + 1,
    project=pinhole.project,
)

MODELS = {PINHOLE.name: PINHOLE, "pinhole": PINHOLE}
# the reference's other model, ported with the remaining models
NOT_PORTED = ("scheimpflug_pinhole_brown_conrady", "scheimpflug")


def get_model(name: str) -> CameraModelSpec:
    if name in MODELS:
        return MODELS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"Camera model '{name}' is not ported yet")
    known = sorted(set(MODELS) | set(NOT_PORTED))
    raise KeyError(f"Unknown camera model '{name}'; known: {known}")
