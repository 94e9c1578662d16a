"""The four-stage pipeline CLI: intrinsics -> stereo? -> hand-eye? ->
bundle? (port of ``calibration_tpu/apps/bundle_pipeline.py``; reference:
apps/examples/bundle_pipeline.cpp:39-139). Writes the artifacts JSON the
JAX app writes.

    python -m calibration_tpu_torch.apps.bundle_pipeline \\
        --input bundle_input.json --output bundle_artifacts.json [--device cuda]

A stage runs when the input's section for it names rigs or pairs.
``--device`` (default ``cuda``) is the torch device of every solve; a CUDA
device that is not there is an error, never a silent run on the CPU. A
failing solve fails the run (``Calibration pipeline failed: ...``, exit 1).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .. import native
from ..utils import profiling
from ._common import resolve_device


@profiling.traced("app.bundle_pipeline")
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Planar intrinsics + hand-eye + bundle adjustment calibration pipeline"
    )
    parser.add_argument("--input", required=True, help="Pipeline input configuration JSON")
    parser.add_argument("--output", default="bundle_artifacts.json")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device of the solves (default cuda)")
    args = parser.parse_args(argv)

    from ..io import jsonio
    from ..pipeline import (
        BundleAdjustmentStage,
        CalibrationPipeline,
        HandEyeCalibrationStage,
        IntrinsicStage,
        JsonPlanarDatasetLoader,
        LoggingDecorator,
        PipelineContext,
        StereoCalibrationStage,
    )
    from ..pipeline.facades.extrinsics import StereoCalibrationConfig
    from ..pipeline.facades.handeye import BundlePipelineConfig, HandEyePipelineConfig
    from ..pipeline.facades.intrinsics import load_calibration_config
    from ._common import load_json_file, report_to_json, resolve_path

    try:
        device = resolve_device(args.device)
        with profiling.span("config"):
            config_json = load_json_file(args.input)
            base_dir = Path(args.input).resolve().parent

            intrinsics_cfg_path = resolve_path(base_dir, config_json["planar_intrinsics_config"])
            planar_cfg = load_calibration_config(intrinsics_cfg_path)
            if planar_cfg is None:
                raise RuntimeError(f"Failed to load planar intrinsics config from {intrinsics_cfg_path}")

            loader = JsonPlanarDatasetLoader()
            for entry in config_json["planar_detections"]:
                loader.add_entry(resolve_path(base_dir, entry["path"]), entry["sensor_id"])

            context = PipelineContext()
            context.set_intrinsics_config(planar_cfg)
            if "stereo" in config_json:
                context.set_stereo_config(jsonio.from_jsonable(config_json["stereo"], StereoCalibrationConfig))
            if "hand_eye" in config_json:
                he_cfg = jsonio.from_jsonable(config_json["hand_eye"], HandEyePipelineConfig)
                if he_cfg.rigs:
                    context.set_handeye_config(he_cfg)
            if "bundle" in config_json:
                bundle_cfg = jsonio.from_jsonable(config_json["bundle"], BundlePipelineConfig)
                if bundle_cfg.rigs:
                    context.set_bundle_config(bundle_cfg)

        pipeline = CalibrationPipeline()
        if args.verbose:
            pipeline.add_decorator(LoggingDecorator(sys.stderr))
        pipeline.add_stage(IntrinsicStage(device))
        if context.has_stereo_config():
            pipeline.add_stage(StereoCalibrationStage(device))
        if context.has_handeye_config():
            pipeline.add_stage(HandEyeCalibrationStage(device))
        if context.has_bundle_config():
            pipeline.add_stage(BundleAdjustmentStage(device))

        report = pipeline.execute(loader, context)
        context.artifacts["pipeline_summary"] = report_to_json(report)

        Path(args.output).write_text(native.dumps_fast(context.artifacts, indent=2) + "\n")
        print(f"Calibration pipeline completed. Artifacts written to {args.output}")
        return 0 if report.success else 1
    except Exception as ex:  # noqa: BLE001 — parity with the app's catch-all
        print(f"Calibration pipeline failed: {ex}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
