from . import extrinsics, handeye, intrinsics, linescan
from .extrinsics import (
    MultiCameraCalibrationFacade,
    MultiCameraCalibrationRunResult,
    MultiCameraRigConfig,
    MultiCameraViewSelection,
    StereoCalibrationConfig,
    StereoCalibrationFacade,
    StereoCalibrationRunResult,
    StereoCalibrationViewSummary,
    StereoPairConfig,
    StereoViewSelection,
)
from .handeye import (
    BundlePipelineConfig,
    BundleRigConfig,
    HandEyeObservationConfig,
    HandEyePipelineConfig,
    HandEyeRigConfig,
)
from .intrinsics import (
    CameraConfig,
    IntrinsicCalibrationConfig,
    IntrinsicCalibrationOptions,
    IntrinsicCalibrationOutputs,
    PlanarIntrinsicCalibrationFacade,
    bounds_from_image_size,
    collect_planar_views,
    load_calibration_config,
    print_calibration_summary,
)
from .linescan import (
    LinescanCalibrationFacade,
    LinescanCalibrationOptions,
    LineScanViewData,
)
