"""Intrinsic calibration from planar target detections CLI (port of
``calibration_tpu/apps/planar_intrinsics.py``): --config + --features per
camera -> per-camera facade run (or one fleet run with --fleet) -> summary
+ report JSON, the same report the JAX app writes.

    python -m calibration_tpu_torch.apps.planar_intrinsics --fleet \\
        --config examples/data/planar_intrinsics_config.json \\
        --features examples/data/detections_cam0.json examples/data/detections_cam1.json \\
        -o report.json [--device cuda]

``--device`` (default ``cuda``) is the torch device of every solve. A CUDA
device that is not there is an error (``Calibration failed: ...``, exit 1),
never a silent run on the CPU. Detections are read through the native
codec when a C++ compiler is available.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .. import native
from ..utils import profiling
from ._common import resolve_device


@profiling.traced("app.planar_intrinsics")
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Intrinsic calibration from planar target detections"
    )
    parser.add_argument("--config", required=True, help="Calibration config JSON")
    parser.add_argument(
        "--features", required=True, nargs="+", help="Detections JSON (repeat per camera)"
    )
    parser.add_argument("-o", "--output", default="", help="Write calibration report JSON")
    parser.add_argument(
        "--fleet",
        action="store_true",
        help="Solve all cameras in one batched device solve per shape "
        "bucket (PlanarIntrinsicCalibrationFacade.calibrate_many) instead "
        "of the reference's serial per-camera loop",
    )
    parser.add_argument("--device", default="cuda", help="torch device of the solves (default cuda)")
    args = parser.parse_args(argv)

    from ..io import jsonio
    from ..pipeline.facades.intrinsics import (
        PlanarIntrinsicCalibrationFacade,
        load_calibration_config,
        print_calibration_summary,
    )
    from ..pipeline.loaders import read_detections
    from ..pipeline.reports import build_planar_intrinsics_report

    try:
        facade = PlanarIntrinsicCalibrationFacade(resolve_device(args.device))
        with profiling.span("config"):
            cfg = load_calibration_config(args.config)
        if cfg is None:
            raise RuntimeError("Failed to load calibration config")
        if len(cfg.cameras) != len(args.features) and not (
            len(args.features) == 1 and len(cfg.cameras) == 1
        ):
            raise RuntimeError(
                f"Number of feature files ({len(args.features)}) does not match cameras "
                f"in config ({len(cfg.cameras)})."
            )

        jobs = []
        for cam_idx, cam_cfg in enumerate(cfg.cameras):
            fpath = args.features[0] if len(args.features) == 1 else args.features[cam_idx]
            print(f"[{cam_cfg.camera_id}] Loading detections from {fpath}", file=sys.stderr)
            detections = read_detections(fpath)
            print(
                f"[{cam_cfg.camera_id}] Found {len(detections.images)} image detections",
                file=sys.stderr,
            )
            jobs.append((cam_cfg, detections))

        fleet_out = facade.calibrate_many(cfg, jobs) if args.fleet else None

        entries = []
        results_json = []
        for cam_idx, (cam_cfg, detections) in enumerate(jobs):
            if fleet_out is not None:
                result = fleet_out[cam_idx]
                if isinstance(result, Exception):
                    raise result
            else:
                result = facade.calibrate(cfg, cam_cfg, detections)
            print_calibration_summary(sys.stdout, cam_cfg, result)
            entries.append((cam_cfg, detections, result))
            results_json.append(
                {
                    "linear_kmtx": result.linear_kmtx.tolist(),
                    "camera": result.refine_result.camera.tolist(),
                    "used_views": result.used_views,
                    "total_points_used": result.total_points_used,
                }
            )
            if len(cfg.cameras) > 1:
                print("-" * 40)

        report = build_planar_intrinsics_report(cfg, entries)
        final_json = {"reports": [jsonio.to_jsonable(report)], "results": results_json}
        text = native.dumps_fast(final_json, indent=2)
        if args.output:
            Path(args.output).write_text(text + "\n")
            print(f"Saved calibration report to {args.output}")
        else:
            print(text)
    except Exception as ex:  # noqa: BLE001 — parity with the app's catch-all
        print(f"Calibration failed: {ex}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
