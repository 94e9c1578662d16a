"""Shared optimizer options/results (reference:
include/calib/estimation/optim/optimize.h).

A copy of ``calibration_tpu/optim/core.py``, which is JAX-free but cannot be
imported without importing JAX (``calibration_tpu/__init__.py`` imports it),
plus ``check_ported`` and ``check_precision``.

``OptimOptions`` keeps the reference's field names and defaults so JSON
configs round-trip; the ``optimizer`` enum is accepted for compatibility but
every problem here is solved with batched dense normal equations (problems
are <= a few hundred parameters; dense Cholesky on the MXU beats sparse
scaffolding at this scale — SURVEY.md section 2 parallelism table).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np


class OptimizerType(str, enum.Enum):
    DEFAULT = "default"
    SPARSE_SCHUR = "sparse_schur"
    DENSE_SCHUR = "dense_schur"
    DENSE_QR = "dense_qr"


@dataclasses.dataclass(frozen=True)
class OptimOptions:
    """Defaults mirror optimize.h:24-33."""

    optimizer: OptimizerType = OptimizerType.DEFAULT
    huber_delta: float = 1.0
    epsilon: float = 1e-9
    max_iterations: int = 1000
    compute_covariance: bool = True
    verbose: bool = False


class TerminationType(enum.IntEnum):
    NO_CONVERGENCE = 0  # hit max_iterations
    FUNCTION_TOLERANCE = 1
    GRADIENT_TOLERANCE = 2
    PARAMETER_TOLERANCE = 3
    NUMERICAL_FAILURE = 4


@dataclasses.dataclass
class OptimResult:
    """Mirrors OptimResult (optimize.h:35-40): success iff the solver
    converged by a tolerance criterion (Ceres CONVERGENCE,
    src/estimation/detail/ceresutils.h:42)."""

    success: bool = False
    # may be a utils.lazy.LazyDeviceArray in fleet paths (deferred D2H fetch;
    # np.asarray / tolist / indexing all materialize it transparently)
    covariance: "np.ndarray | Any | None" = None
    report: str = "Empty"
    final_cost: float = 0.0
    # extras beyond the reference (additive, does not break parity)
    iterations: int = 0
    termination: TerminationType = TerminationType.NO_CONVERGENCE
    initial_cost: float = 0.0


def check_ported(model=None, models=("pinhole_brown_conrady",)):
    """The port takes the reference's parameters and honours, per caller,
    the camera models named in ``models`` (a model given as a spec or a
    name); any other model raises ``NotImplementedError`` (not ported yet
    on that path). Returns the port's spec of ``model`` (pinhole when it is
    None)."""
    from ..models.registry import PINHOLE, get_model

    spec = PINHOLE if model is None else get_model(getattr(model, "name", model))
    if spec.name not in models:
        raise NotImplementedError(f"Camera model '{spec.name}' is not ported yet on this path")
    return spec


def check_precision(precision: str, precisions: tuple) -> None:
    """Raise ``ValueError`` unless ``precision`` is one of the
    ``precisions`` a path takes."""
    if precision not in precisions:
        raise ValueError(f"precision '{precision}' is not taken here ({' | '.join(precisions)})")


def brief_report(result: "OptimResult") -> str:
    """Ceres-BriefReport-shaped summary string."""
    term = {
        TerminationType.NO_CONVERGENCE: "NO_CONVERGENCE",
        TerminationType.FUNCTION_TOLERANCE: "CONVERGENCE (function tolerance)",
        TerminationType.GRADIENT_TOLERANCE: "CONVERGENCE (gradient tolerance)",
        TerminationType.PARAMETER_TOLERANCE: "CONVERGENCE (parameter tolerance)",
        TerminationType.NUMERICAL_FAILURE: "FAILURE (numerical)",
    }[result.termination]
    return (
        f"calibration_tpu LM: initial cost {result.initial_cost:.6e}, "
        f"final cost {result.final_cost:.6e}, iterations {result.iterations}, {term}"
    )
