"""Pipeline orchestration core (reference: include/calib/pipeline/pipeline.h
+ src/pipeline/pipeline.cpp): sequential stages over a shared context with
decorator before/after hooks; report success is the AND of stage successes
(pipeline.cpp:36-62).

A copy of ``calibration_tpu/pipeline/pipeline.py``, which is JAX-free but cannot be
imported without importing JAX (``calibration_tpu/__init__.py`` imports it).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

from ..utils import profiling
from .dataset import CalibrationDataset
from .loaders import DatasetLoader


@dataclasses.dataclass
class PipelineStageResult:
    """pipeline.h:20-24."""

    name: str = ""
    success: bool = False
    summary: Dict[str, Any] = dataclasses.field(default_factory=dict)
    duration_s: float = 0.0  # wall time of stage.run (observability; not in
    # the reference report — harmless extra field for profiling pipelines)


@dataclasses.dataclass
class PipelineExecutionReport:
    """pipeline.h:26-29."""

    success: bool = False
    stages: List[PipelineStageResult] = dataclasses.field(default_factory=list)


class PipelineContext:
    """Shared state between stages (pipeline.h:35-78): optional configs, the
    dataset, per-sensor/rig result maps, and free-form artifacts JSON."""

    def __init__(self) -> None:
        self.dataset: CalibrationDataset = CalibrationDataset()
        self.intrinsic_results: Dict[str, Any] = {}
        self.stereo_results: Dict[str, Any] = {}
        self.handeye_results: Dict[str, Dict[str, Any]] = {}
        self.bundle_results: Dict[str, Any] = {}
        self.artifacts: Dict[str, Any] = {}
        self._intrinsics_config = None
        self._stereo_config = None
        self._handeye_config = None
        self._bundle_config = None

    # config setters/getters mirroring pipeline.h:54-77
    def set_intrinsics_config(self, cfg) -> None:
        self._intrinsics_config = cfg

    def set_stereo_config(self, cfg) -> None:
        self._stereo_config = cfg

    def set_handeye_config(self, cfg) -> None:
        self._handeye_config = cfg

    def set_bundle_config(self, cfg) -> None:
        self._bundle_config = cfg

    def has_intrinsics_config(self) -> bool:
        return self._intrinsics_config is not None

    def intrinsics_config(self):
        return self._intrinsics_config

    def has_stereo_config(self) -> bool:
        return self._stereo_config is not None

    def stereo_config(self):
        return self._stereo_config

    def has_handeye_config(self) -> bool:
        return self._handeye_config is not None

    def handeye_config(self):
        return self._handeye_config

    def has_bundle_config(self) -> bool:
        return self._bundle_config is not None

    def bundle_config(self):
        return self._bundle_config


class CalibrationStage:
    """pipeline.h:80-86."""

    def name(self) -> str:
        raise NotImplementedError

    def run(self, context: PipelineContext) -> PipelineStageResult:
        raise NotImplementedError


class StageDecorator:
    """pipeline.h:88-95."""

    def before_stage(self, stage: CalibrationStage, context: PipelineContext) -> None:
        pass

    def after_stage(
        self, stage: CalibrationStage, context: PipelineContext, result: PipelineStageResult
    ) -> None:
        pass


class LoggingDecorator(StageDecorator):
    """pipeline.cpp:64-72."""

    def __init__(self, out=None):
        self.out = out if out is not None else sys.stdout

    def before_stage(self, stage, context):
        print(f"[pipeline] → Starting stage '{stage.name()}'", file=self.out)

    def after_stage(self, stage, context, result):
        status = " (success)" if result.success else " (failed)"
        print(
            f"[pipeline] ← Completed stage '{stage.name()}'{status}"
            f" [{result.duration_s:.2f}s]",
            file=self.out,
        )


class CalibrationPipeline:
    """pipeline.h:104-113 + pipeline.cpp:28-62."""

    def __init__(self) -> None:
        self._stages: List[CalibrationStage] = []
        self._decorators: List[StageDecorator] = []

    def add_stage(self, stage: CalibrationStage) -> None:
        self._stages.append(stage)

    def add_decorator(self, decorator: StageDecorator) -> None:
        self._decorators.append(decorator)

    def execute(self, loader: DatasetLoader, context: PipelineContext) -> PipelineExecutionReport:
        context.dataset = loader.load()
        report = PipelineExecutionReport(success=True)
        for stage in self._stages:
            for deco in self._decorators:
                deco.before_stage(stage, context)
            t0 = time.perf_counter()
            with profiling.span(f"stage.{stage.name()}"):
                result = stage.run(context)
            result.duration_s = time.perf_counter() - t0
            if not result.name:
                result.name = stage.name()
            for deco in self._decorators:
                deco.after_stage(stage, context, result)
            report.success = report.success and result.success
            report.stages.append(result)
        return report
