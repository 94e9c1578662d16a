"""Line-scan laser-plane calibration CLI (port of
``calibration_tpu/apps/linescan_calibration.py``). Writes the artifact JSON
the JAX app writes.

    python -m calibration_tpu_torch.apps.linescan_calibration \\
        --input examples/data/linescan_input.json --output ls.json [--device cuda]

Input JSON: {"camera": {"kmtx": {...}, "distortion": {"coeffs": [...]},
"model": "pinhole_brown_conrady" | "scheimpflug...", "tilt": {"taux",
"tauy"}}, "views": [{"target_view": [{"object_xy", "image_uv"}...],
"laser_uv": [[u, v]...]}...], "plane_fit": {"method": "svd" | "ransac",
"ransac": {...}}?}; positional ``field_N`` keys are read where the JAX app
reads them. ``--device`` (default ``cuda``) is the torch device of the
fit. A CUDA device that is not there is an error (``Linescan calibration
failed: ...``, exit 1), never a silent run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from .. import native
from ..utils import profiling
from ._common import resolve_device


def _camera(cam_json):
    """(flat intrinsics, model name) of the input's camera section."""
    from ..models import pinhole, scheimpflug

    km = cam_json.get("kmtx", cam_json.get("field_0", {}))
    kmtx = np.array([
        km.get("fx", km.get("field_0", 0.0)),
        km.get("fy", km.get("field_1", 0.0)),
        km.get("cx", km.get("field_2", 0.0)),
        km.get("cy", km.get("field_3", 0.0)),
        km.get("skew", km.get("field_4", 0.0)),
    ], float)
    coeffs = np.asarray(cam_json.get("distortion", {}).get("coeffs", [0.0] * 5), float)
    camera = pinhole.pack(kmtx, coeffs)
    # any registry camera model; Scheimpflug adds {"tilt": {"taux", "tauy"}}
    model_name = cam_json.get("model", "pinhole_brown_conrady")
    if model_name.startswith("scheimpflug"):
        tilt = cam_json.get("tilt", {})
        camera = scheimpflug.pack(
            camera, tilt.get("taux", tilt.get("field_0", 0.0)), tilt.get("tauy", tilt.get("field_1", 0.0))
        )
    return camera.numpy(), model_name


@profiling.traced("app.linescan_calibration")
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Line-scan laser plane calibration (linear)")
    parser.add_argument("--input", required=True, help="Input JSON (camera, views)")
    parser.add_argument("--output", default="linescan_artifacts.json")
    parser.add_argument("--device", default="cuda", help="torch device of the fit (default cuda)")
    args = parser.parse_args(argv)

    from ..pipeline.facades.intrinsics import RansacConfig
    from ..pipeline.facades.linescan import LinescanCalibrationFacade, LinescanCalibrationOptions, LineScanViewData

    try:
        device = resolve_device(args.device)
        j = json.loads(Path(args.input).read_text())
        camera, model_name = _camera(j["camera"])

        views = []
        for vj in j["views"]:
            tv = vj["target_view"]
            obj = np.array([p.get("object_xy", p.get("field_0")) for p in tv], float)
            uv = np.array([p.get("image_uv", p.get("field_1")) for p in tv], float)
            laser = np.array(vj["laser_uv"], float)
            if laser.ndim != 2 or laser.shape[1] != 2:
                raise RuntimeError("laser_uv entry must be [u,v]")
            views.append(LineScanViewData(obj, uv, laser))

        options = LinescanCalibrationOptions()
        pf = j.get("plane_fit")
        if pf is not None and pf.get("method", "svd").lower() == "ransac":
            options.plane_fit.use_ransac = True
            ro = pf.get("ransac", {})
            options.plane_fit.ransac_options = RansacConfig(
                max_iters=ro.get("max_iters", 1000),
                thresh=ro.get("thresh", 2.0),
                min_inliers=ro.get("min_inliers", 12),
                confidence=ro.get("confidence", 0.99),
                seed=ro.get("seed", 1234567),
                refit_on_inliers=ro.get("refit_on_inliers", True),
            )

        run = LinescanCalibrationFacade(device).calibrate(camera, views, options, model=model_name)
        out = {
            "success": run.success,
            "used_views": run.used_views,
            "plane": {
                "n": [float(x) for x in run.result.plane[:3]],
                "d": float(run.result.plane[3]),
                "method": run.result.summary,
                "inliers": run.result.inlier_count,
            },
            "rms_error": run.result.rms_error,
            "homography": run.result.homography.tolist(),
        }
        Path(args.output).write_text(native.dumps_fast(out, indent=2) + "\n")
        print(f"Linescan calibration artifacts written to {args.output}")
        return 0 if run.success else 1
    except Exception as ex:  # noqa: BLE001 — the app reports any failure on one line
        print(f"Linescan calibration failed: {ex}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
