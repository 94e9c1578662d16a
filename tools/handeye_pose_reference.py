#!/usr/bin/env python3
"""The JAX reference's own hand-eye pose error on the hand-eye pipeline
fleet of ``chip_smoke.py``: the basis of its HE_POSE_TOL_M / HE_POSE_TOL_DEG
bound.

    JAX_PLATFORMS=cpu python3 tools/handeye_pose_reference.py [--rigs 64] [--port]

Writes the JAX package's ``benchmarks/pipeline_fleet.make_fleet`` (which
``chip_smoke.write_handeye_fleet`` restates) without its bundle section,
runs the JAX ``bundle_pipeline`` app (intrinsics, then hand-eye) on it on
the CPU, and prints the worst rig's g_se3_c error against the truth beside
the bound the smoke holds the port to. With ``--port`` the port's
``bundle_pipeline`` runs on the same input on the CPU and its worst rig is
printed too. Needs JAX, so it runs beside the repository's tests, not on
the card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from benchmarks import pipeline_fleet  # noqa: E402


def worst_rig(app_main, input_path, out, rigs, g_gt, extra=()):
    with contextlib.redirect_stdout(io.StringIO()):
        rc = app_main(["--input", str(input_path), "--output", str(out), *extra])
    if rc != 0:
        raise SystemExit(f"bundle_pipeline exited {rc}")
    art = json.loads(Path(out).read_text())
    g = np.array([art["hand_eye"][f"rig{r}"]["sensors"][f"cam{r}"]["g_se3_c"] for r in range(rigs)])
    return chip_smoke.pose_errors(g, g_gt)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rigs", type=int, default=chip_smoke.HE_PIPELINE_RIGS)
    parser.add_argument("--port", action="store_true", help="also run the port's app on the CPU")
    args = parser.parse_args()
    from calibration_tpu.apps import bundle_pipeline as jax_app

    with tempfile.TemporaryDirectory() as tmp:
        fleet = pipeline_fleet.make_fleet(Path(tmp) / "fleet", rigs=args.rigs)
        data = json.loads(Path(fleet["input_path"]).read_text())
        data.pop("bundle")
        input_path = Path(fleet["input_path"]).with_name("handeye_input.json")
        input_path.write_text(json.dumps(data))
        tra, rot = worst_rig(jax_app.main, input_path, Path(tmp) / "jax.json", args.rigs, fleet["g_gt"])
        print(f"JAX reference (CPU), worst of {args.rigs} rigs: {tra!r} m, {rot!r} deg; the smoke's bound "
              f"{chip_smoke.HE_POSE_TOL_M} m, {chip_smoke.HE_POSE_TOL_DEG} deg "
              f"({chip_smoke.HE_POSE_TOL_M / tra:.2f}x, {chip_smoke.HE_POSE_TOL_DEG / rot:.2f}x)")
        if args.port:
            from calibration_tpu_torch.apps import bundle_pipeline as port_app

            tra, rot = worst_rig(port_app.main, input_path, Path(tmp) / "port.json", args.rigs, fleet["g_gt"],
                                 ("--device", "cpu"))
            print(f"port (CPU), worst of {args.rigs} rigs: {tra!r} m, {rot!r} deg")
    return 0


if __name__ == "__main__":
    sys.exit(main())
