"""Intrinsics + extrinsics (stereo or multicam) pipeline CLI (port of
``calibration_tpu/apps/intrinsic_extrinsic_pipeline.py``): the intrinsics
stage, the stereo stage when the input has a ``stereo`` section, then the
``multicam`` rigs, then the artifacts JSON, the same artifacts the JAX app
writes.

    python -m calibration_tpu_torch.apps.intrinsic_extrinsic_pipeline \\
        --input examples/data/pipeline_input.json --output artifacts.json [--device cuda]

``--device`` (default ``cuda``) is the torch device of every solve. A CUDA
device that is not there is an error (``Calibration pipeline failed: ...``,
exit 1), never a silent run on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from .. import native
from ..utils import profiling
from ._common import resolve_device


def _multicam_entry(run) -> dict:
    entry = {
        "success": run.success,
        "requested_views": run.requested_views,
        "used_views": run.used_views,
        "sensors": run.sensors,
        "initial_guess": {
            "c_se3_r": [np.asarray(m).tolist() for m in run.initial_guess.c_se3_r],
            "r_se3_t": [np.asarray(m).tolist() for m in run.initial_guess.r_se3_t],
        },
    }
    if run.optimization is not None:
        entry["optimization"] = {
            "success": run.optimization.core.success,
            "final_cost": run.optimization.core.final_cost,
            "report": run.optimization.core.report,
            "cameras": [c.tolist() for c in run.optimization.cameras],
            "c_se3_r": [m.tolist() for m in run.optimization.c_se3_r],
            "r_se3_t": [m.tolist() for m in run.optimization.r_se3_t],
        }
    return entry


@profiling.traced("app.intrinsic_extrinsic_pipeline")
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Planar intrinsics and extrinsics calibration example (stereo or multicam)"
    )
    parser.add_argument("--input", required=True, help="Pipeline input configuration JSON")
    parser.add_argument("--output", default="artifacts.json")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--device", default="cuda", help="torch device of the solves (default cuda)")
    args = parser.parse_args(argv)

    from ..io import jsonio
    from ..pipeline import (
        CalibrationPipeline,
        IntrinsicStage,
        JsonPlanarDatasetLoader,
        LoggingDecorator,
        PipelineContext,
        StereoCalibrationStage,
    )
    from ..pipeline.facades.extrinsics import (
        MultiCameraCalibrationFacade,
        MultiCameraRigConfig,
        StereoCalibrationConfig,
    )
    from ..pipeline.facades.intrinsics import load_calibration_config
    from ._common import load_json_file, report_to_json, resolve_path

    try:
        device = resolve_device(args.device)
        config_json = load_json_file(args.input)
        base_dir = Path(args.input).resolve().parent

        intrinsics_path = resolve_path(base_dir, config_json["planar_intrinsics_config"])
        planar_cfg = load_calibration_config(intrinsics_path)
        if planar_cfg is None:
            raise RuntimeError(f"Failed to load planar intrinsics config from {intrinsics_path}")

        loader = JsonPlanarDatasetLoader()
        for entry in config_json["planar_detections"]:
            loader.add_entry(resolve_path(base_dir, entry["path"]), entry["sensor_id"])

        context = PipelineContext()
        context.set_intrinsics_config(planar_cfg)
        if "stereo" in config_json:
            context.set_stereo_config(jsonio.from_jsonable(config_json["stereo"], StereoCalibrationConfig))

        pipeline = CalibrationPipeline()
        if args.verbose:
            pipeline.add_decorator(LoggingDecorator(sys.stderr))
        pipeline.add_stage(IntrinsicStage(device))
        if context.has_stereo_config():
            pipeline.add_stage(StereoCalibrationStage(device))

        report = pipeline.execute(loader, context)
        context.artifacts["pipeline_summary"] = report_to_json(report)

        mc_failed = False
        if "multicam" in config_json:
            mc = config_json["multicam"]
            rigs = [jsonio.from_jsonable(r, MultiCameraRigConfig) for r in (mc if isinstance(mc, list) else [mc])]
            det_by_sensor = {d.sensor_id: d for d in context.dataset.planar_cameras if d.sensor_id}
            mc_artifacts = context.artifacts.setdefault("multicam", {})
            # one batched DLT + LM per rig shape bucket
            runs = MultiCameraCalibrationFacade(device).calibrate_many(
                [(rig, det_by_sensor, context.intrinsic_results) for rig in rigs]
            )
            for rig, run in zip(rigs, runs):
                if isinstance(run, Exception):
                    # a rig whose host walk raised fails the exit code; the
                    # other rigs are still reported
                    print(f"Multicam calibration failed: {run}", file=sys.stderr)
                    mc_artifacts[rig.rig_id or "rig0"] = {"success": False, "error": str(run)}
                    mc_failed = True
                    continue
                mc_artifacts[rig.rig_id or "rig0"] = _multicam_entry(run)

        Path(args.output).write_text(native.dumps_fast(context.artifacts, indent=2) + "\n")
        print(f"Calibration artifacts written to {args.output}")
        return 0 if (report.success and not mc_failed) else 1
    except Exception as ex:  # noqa: BLE001 — parity with the app's catch-all
        print(f"Calibration pipeline failed: {ex}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
