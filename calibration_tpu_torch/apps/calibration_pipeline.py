"""End-to-end pipeline CLI: intrinsics -> stereo -> hand-eye (port of
``calibration_tpu/apps/calibration_pipeline.py``; reference:
apps/examples/calibration_pipeline.cpp:31-93). Prints the pipeline report
JSON the JAX app prints.

    python -m calibration_tpu_torch.apps.calibration_pipeline \\
        --config examples/data/planar_intrinsics_config.json \\
        --features cam0=examples/data/detections_cam0.json [--device cuda]

As in the reference, no stereo or hand-eye configuration is read here, so
those stages report ``missing_config``. ``--device`` (default ``cuda``) is
the torch device of every solve; a CUDA device that is not there is an
error (``Pipeline execution failed: ...``, exit 1).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .. import native
from ..utils import profiling
from ._common import resolve_device


@profiling.traced("app.calibration_pipeline")
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="End-to-end calibration pipeline (intrinsics -> stereo -> hand-eye)"
    )
    parser.add_argument("--config", required=True, help="Planar calibration configuration")
    parser.add_argument(
        "--features", required=True, nargs="+",
        help="Feature dataset files. Accepts path or sensor_id=path syntax.",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device of the solves (default cuda)")
    args = parser.parse_args(argv)

    from ..pipeline import (
        CalibrationPipeline,
        HandEyeCalibrationStage,
        IntrinsicStage,
        JsonPlanarDatasetLoader,
        LoggingDecorator,
        PipelineContext,
        StereoCalibrationStage,
    )
    from ..pipeline.facades.intrinsics import load_calibration_config
    from ._common import report_to_json, split_sensor_entry

    try:
        device = resolve_device(args.device)
        config = load_calibration_config(args.config)
        if config is None:
            raise RuntimeError(f"Failed to load calibration config from {args.config}")

        loader = JsonPlanarDatasetLoader()
        for entry in args.features:
            sensor_id, path = split_sensor_entry(entry)
            if not Path(path).exists():
                raise RuntimeError(f"Feature file not found: {path}")
            loader.add_entry(path, sensor_id)

        context = PipelineContext()
        context.set_intrinsics_config(config)

        pipeline = CalibrationPipeline()
        if args.verbose:
            pipeline.add_decorator(LoggingDecorator(sys.stderr))
        pipeline.add_stage(IntrinsicStage(device))
        pipeline.add_stage(StereoCalibrationStage(device))
        pipeline.add_stage(HandEyeCalibrationStage(device))

        report = pipeline.execute(loader, context)
        print(native.dumps_fast(report_to_json(report), indent=2))
        return 0 if report.success else 1
    except Exception as ex:  # noqa: BLE001 — parity with the app's catch-all
        print(f"Pipeline execution failed: {ex}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
