"""Carry inputs from the JAX package into the port and results back.

Option dataclasses convert field by field from ``dataclasses.asdict``
(fields the port does not read are dropped); arrays become tensors on a
given device; results (tensors, NamedTuples, tuples) come back as numpy.
Nothing here imports JAX: the JAX objects are read through the dataclass
protocol and ``numpy.asarray``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.camera_matrix import CalibrationBounds
from .ops.handeye_linear import MotionPairs
from .optim.bundle import BundleOptions
from .optim.core import OptimizerType, OptimOptions
from .optim.extrinsics import ExtrinsicOptions
from .optim.intrinsics import IntrinsicsOptimOptions
from .utils import profiling


def _known_fields(cls, values: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in values.items() if k in names}


def _optim_options(values: dict) -> OptimOptions:
    values = _known_fields(OptimOptions, values)
    if "optimizer" in values:
        values["optimizer"] = OptimizerType(getattr(values["optimizer"], "value", values["optimizer"]))
    return OptimOptions(**values)


def optim_options(opts) -> OptimOptions:
    """The reference's ``OptimOptions`` -> the port's."""
    return _optim_options(dataclasses.asdict(opts))


def intrinsics_options(opts) -> IntrinsicsOptimOptions:
    """The reference's ``IntrinsicsOptimOptions`` -> the port's."""
    values = _known_fields(IntrinsicsOptimOptions, dataclasses.asdict(opts))
    values["core"] = _optim_options(values["core"])
    if values["bounds"] is not None:
        values["bounds"] = CalibrationBounds(**values["bounds"])
    return IntrinsicsOptimOptions(**values)


def extrinsic_options(opts) -> ExtrinsicOptions:
    """The reference's ``ExtrinsicOptions`` -> the port's."""
    values = _known_fields(ExtrinsicOptions, dataclasses.asdict(opts))
    values["core"] = _optim_options(values["core"])
    return ExtrinsicOptions(**values)


def bundle_options(opts) -> BundleOptions:
    """The reference's ``BundleOptions`` -> the port's."""
    values = _known_fields(BundleOptions, dataclasses.asdict(opts))
    values["core"] = _optim_options(values["core"])
    return BundleOptions(**values)


def calibration_bounds(bounds) -> CalibrationBounds | None:
    """The reference's ``CalibrationBounds`` (or None) -> the port's."""
    if bounds is None:
        return None
    return CalibrationBounds(**dataclasses.asdict(bounds))


def _observations(rig):
    from .pipeline.facades.handeye import HandEyeObservationConfig

    return [
        HandEyeObservationConfig(
            view_id=o.view_id, base_se3_gripper=np.array(o.base_se3_gripper, float), images=dict(o.images)
        )
        for o in rig.observations
    ]


def handeye_pipeline_config(cfg):
    """The reference's ``HandEyePipelineConfig`` -> the port's."""
    # imported here: the pipeline package imports this module
    from .pipeline.facades.handeye import HandEyePipelineConfig, HandEyeRigConfig

    return HandEyePipelineConfig(rigs=[
        HandEyeRigConfig(
            rig_id=rig.rig_id, sensors=list(rig.sensors), observations=_observations(rig),
            options=optim_options(rig.options), min_angle_deg=rig.min_angle_deg,
        )
        for rig in cfg.rigs
    ])


def bundle_pipeline_config(cfg):
    """The reference's ``BundlePipelineConfig`` -> the port's."""
    from .pipeline.facades.handeye import BundlePipelineConfig, BundleRigConfig

    return BundlePipelineConfig(rigs=[
        BundleRigConfig(
            rig_id=rig.rig_id, sensors=list(rig.sensors), observations=_observations(rig),
            options=bundle_options(rig.options), min_angle_deg=rig.min_angle_deg,
            initial_target=None if rig.initial_target is None else np.array(rig.initial_target, float),
        )
        for rig in cfg.rigs
    ])


def motion_pairs(pairs, device) -> MotionPairs:
    """The reference's ``MotionPairs`` (any leading dims) -> the port's,
    float64 on ``device``."""
    return MotionPairs(*(to_tensor(a, device) for a in pairs))


def to_tensor(a, device, dtype=torch.float64) -> torch.Tensor:
    """An array (numpy, or anything ``numpy.asarray`` reads) -> a tensor
    that owns a copy of it."""
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def to_numpy(tree):
    """Tensors, NamedTuples, tuples and lists of them -> numpy: results
    copied out, one ``profiling.sync`` (the first copy waits for the
    device)."""
    with profiling.sync("to_numpy"):
        return _to_numpy(tree)


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(t) for t in tree)
    return tree
