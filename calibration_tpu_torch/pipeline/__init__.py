from . import dataset, fleet, loaders, pipeline, planar_utils, reports, stages
from .dataset import (
    CalibrationDataset,
    PlanarDetections,
    PlanarImageDetections,
    PlanarTargetPoint,
)
from .loaders import DatasetLoader, JsonPlanarDatasetLoader
from .pipeline import (
    CalibrationPipeline,
    CalibrationStage,
    LoggingDecorator,
    PipelineContext,
    PipelineExecutionReport,
    PipelineStageResult,
    StageDecorator,
)
from .stages import BundleAdjustmentStage, HandEyeCalibrationStage, IntrinsicStage, StereoCalibrationStage
