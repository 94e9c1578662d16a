"""Homography estimation & refinement CLI (port of
``calibration_tpu/apps/homography.py``; reference:
apps/examples/homography.cpp). Writes the JSON the JAX app writes.

    python -m calibration_tpu_torch.apps.homography \\
        --input examples/data/homography_input.json --pretty [--device cuda]

Input JSON: {"correspondences": [{"object_xy": [x, y], "image_uv": [u, v]}
...], "ransac": {...}?, "optimize": true, "options": {...}}. ``--device``
(default ``cuda``) is the torch device of the estimate and the refine. A
CUDA device that is not there is an error (``Homography failed: ...``,
exit 1), never a silent run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .. import native
from ..utils import profiling
from ._common import resolve_device


@profiling.traced("app.homography")
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Homography estimation and refinement example")
    parser.add_argument("--input", required=True, help="Input JSON with correspondences")
    parser.add_argument("-o", "--output", default="", help="Optional output JSON file")
    parser.add_argument("--pretty", action="store_true", help="Pretty-print JSON output")
    parser.add_argument("--no-refine", action="store_true", help="Skip non-linear refinement")
    parser.add_argument("--device", default="cuda", help="torch device of the solves (default cuda)")
    args = parser.parse_args(argv)

    from ..io import jsonio
    from ..ops import homography as H
    from ..optim import OptimOptions, optimize_homography
    from ..pipeline.facades.intrinsics import RansacConfig

    try:
        device = resolve_device(args.device)
    except RuntimeError as ex:
        print(f"Homography failed: {ex}", file=sys.stderr)
        return 1
    try:
        input_json = json.loads(Path(args.input).read_text())
    except OSError:
        print(f"Failed to open input file: {args.input}", file=sys.stderr)
        return 1

    corr = input_json.get("correspondences", input_json.get("field_0", []))
    obj = np.array([c.get("object_xy", c.get("field_0")) for c in corr], float)
    uv = np.array([c.get("image_uv", c.get("field_1")) for c in corr], float)
    if obj.shape[0] < 4:
        print("Failed to estimate homography", file=sys.stderr)
        return 1

    ransac_cfg = input_json.get("ransac")
    run_refine = (not args.no_refine) and bool(input_json.get("optimize", True))
    options = (
        jsonio.from_jsonable(input_json.get("options", {}), OptimOptions)
        if input_json.get("options")
        else OptimOptions()
    )

    obj_d = torch.as_tensor(obj, device=device)
    uv_d = torch.as_tensor(uv, device=device)
    est = H.estimate_homography(
        obj_d, uv_d, ransac_options=None if ransac_cfg is None else jsonio.from_jsonable(ransac_cfg, RansacConfig).to_options()
    )
    success = bool(est["success"]) if ransac_cfg is not None else bool(torch.isfinite(est["hmtx"]).all())
    if not success:
        print("Failed to estimate homography", file=sys.stderr)
        return 1
    hmtx = est["hmtx"]
    inliers = [int(i) for i in np.where(est["inlier_mask"].cpu().numpy())[0]]

    output = {
        "success": True,
        "correspondence_count": int(obj.shape[0]),
        "estimated": {
            "success": success,
            "hmtx": hmtx.cpu().numpy().tolist(),
            "inliers": inliers,
            "symmetric_rms_px": float(est["symmetric_rms_px"]),
        },
    }
    if run_refine:
        refined = optimize_homography(obj_d, uv_d, hmtx, options)
        opt_json = {
            "core": {
                "success": refined.core.success,
                "report": refined.core.report,
                "final_cost": refined.core.final_cost,
            },
            "homography": refined.homography.tolist(),
        }
        if refined.core.covariance is not None:
            opt_json["core"]["covariance"] = refined.core.covariance.tolist()
        output["optimized"] = opt_json

    text = native.dumps_fast(output, indent=2 if args.pretty else None)
    if args.output:
        Path(args.output).write_text(text + "\n")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
