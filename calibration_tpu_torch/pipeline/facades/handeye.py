"""Hand-eye and bundle pipeline configs (port of
``calibration_tpu/pipeline/facades/handeye.py``; reference:
include/calib/pipeline/facades/handeye.h:35-76), field for field and in the
reference's order, so JSON inputs and the artifacts' positional ``field_N``
keys match.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ...optim.bundle import BundleOptions
from ...optim.core import OptimOptions


@dataclasses.dataclass
class HandEyeObservationConfig:
    """facades/handeye.h:35-39: one robot pose + per-sensor image refs."""

    view_id: str = ""
    base_se3_gripper: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(4))
    images: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class HandEyeRigConfig:
    """facades/handeye.h:44-50."""

    rig_id: str = ""
    sensors: List[str] = dataclasses.field(default_factory=list)
    observations: List[HandEyeObservationConfig] = dataclasses.field(default_factory=list)
    options: OptimOptions = dataclasses.field(default_factory=OptimOptions)
    min_angle_deg: float = 1.0


@dataclasses.dataclass
class HandEyePipelineConfig:
    """facades/handeye.h:52-54."""

    rigs: List[HandEyeRigConfig] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BundleRigConfig:
    """facades/handeye.h:59-66."""

    rig_id: str = ""
    sensors: List[str] = dataclasses.field(default_factory=list)
    observations: List[HandEyeObservationConfig] = dataclasses.field(default_factory=list)
    options: BundleOptions = dataclasses.field(default_factory=BundleOptions)
    min_angle_deg: float = 1.0
    initial_target: Optional[np.ndarray] = None


@dataclasses.dataclass
class BundlePipelineConfig:
    """facades/handeye.h:68-70."""

    rigs: List[BundleRigConfig] = dataclasses.field(default_factory=list)
