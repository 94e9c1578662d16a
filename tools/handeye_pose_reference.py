#!/usr/bin/env python3
"""The JAX reference's own g_se3_c error on the sets of ``chip_smoke.py``:
the basis of its HE_POSE_TOL, BUNDLE_PIPE_TOL and BUNDLE_TOL bounds.

    JAX_PLATFORMS=cpu python3 tools/handeye_pose_reference.py [--rigs 64] [--bundle] [--port]

Writes the JAX package's ``benchmarks/pipeline_fleet.make_fleet`` (which
``chip_smoke.write_handeye_fleet`` restates) without its bundle section,
runs the JAX ``bundle_pipeline`` app (intrinsics, then hand-eye) on it on
the CPU, and prints the worst rig's g_se3_c error against the truth beside
the bound the smoke holds the port to. With ``--bundle`` it runs the app on
the fleet with its bundle section instead and prints the worst rig after
the bundle stage, then solves config 5 (``benchmarks/problems.
bundle_problems`` at B = 128, as ``bench_all.py`` calls ``bundle_batch``)
and prints the worst lane. With ``--port`` the port does the same on the
CPU and its worst rig or lane is printed too. Needs JAX, so it runs beside
the repository's tests, not on the card.
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
from benchmarks import pipeline_fleet, problems  # noqa: E402


def worst_rig(app_main, input_path, out, rigs, g_gt, extra=(), stage="hand_eye"):
    with contextlib.redirect_stdout(io.StringIO()):
        rc = app_main(["--input", str(input_path), "--output", str(out), *extra])
    if rc != 0:
        raise SystemExit(f"bundle_pipeline exited {rc}")
    art = json.loads(Path(out).read_text())
    if stage == "bundle":
        g = np.array([art["bundle"][f"rig{r}"]["result"]["g_se3_c"][0] for r in range(rigs)])
    else:
        g = np.array([art["hand_eye"][f"rig{r}"]["sensors"][f"cam{r}"]["g_se3_c"] for r in range(rigs)])
    return chip_smoke.pose_errors(g, g_gt)


def worst_bundle_lane(port: bool):
    """Config 5 through the JAX package's bundle_batch (or the port's on
    the CPU), as bench_all.py calls it; the worst lane's g_se3_c error."""
    p = problems.bundle_problems(chip_smoke.BUNDLE_RIGS)
    if port:
        from calibration_tpu_torch.parallel import bundle_batch

        out = bundle_batch(*chip_smoke.bundle_args(p, "cpu"), opts=chip_smoke.BUNDLE_OPTS)
        g, ok = out[2][:, 0].numpy(), bool(out[0].success.all())
    else:
        from calibration_tpu.optim import BundleOptions, OptimOptions
        from calibration_tpu.parallel import batched

        b, o = p["bg"].shape[:2]
        opts = BundleOptions(core=OptimOptions(max_iterations=50, compute_covariance=False))
        out = batched.bundle_batch(p["obj"], p["uv"], p["bg"], np.zeros((b, o), int),
                                   np.tile(p["intr"][None, None], (b, 1, 1)), p["g0"][:, None], p["b0"], opts=opts)
        g, ok = np.asarray(out[2])[:, 0], bool(np.asarray(out[0].success).all())
    if not ok:
        raise SystemExit("a config-5 lane did not converge")
    return chip_smoke.pose_errors(g, p["g_gt"])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rigs", type=int, default=chip_smoke.HE_PIPELINE_RIGS)
    parser.add_argument("--bundle", action="store_true",
                        help="the four-stage pipeline's bundle g_se3_c, and config 5")
    parser.add_argument("--port", action="store_true", help="also run the port on the CPU")
    args = parser.parse_args()
    from calibration_tpu.apps import bundle_pipeline as jax_app

    stage = "bundle" if args.bundle else "hand_eye"
    tol_m, tol_deg = ((chip_smoke.BUNDLE_PIPE_TOL_M, chip_smoke.BUNDLE_PIPE_TOL_DEG) if args.bundle
                      else (chip_smoke.HE_POSE_TOL_M, chip_smoke.HE_POSE_TOL_DEG))
    with tempfile.TemporaryDirectory() as tmp:
        fleet = pipeline_fleet.make_fleet(Path(tmp) / "fleet", rigs=args.rigs)
        input_path = Path(fleet["input_path"])
        if not args.bundle:
            data = json.loads(input_path.read_text())
            data.pop("bundle")
            input_path = input_path.with_name("handeye_input.json")
            input_path.write_text(json.dumps(data))
        tra, rot = worst_rig(jax_app.main, input_path, Path(tmp) / "jax.json", args.rigs, fleet["g_gt"], stage=stage)
        print(f"JAX reference (CPU), {stage} stage, worst of {args.rigs} rigs: {tra!r} m, {rot!r} deg; the "
              f"smoke's bound {tol_m} m, {tol_deg} deg ({tol_m / tra:.2f}x, {tol_deg / rot:.2f}x)")
        if args.port:
            from calibration_tpu_torch.apps import bundle_pipeline as port_app

            tra, rot = worst_rig(port_app.main, input_path, Path(tmp) / "port.json", args.rigs, fleet["g_gt"],
                                 ("--device", "cpu"), stage=stage)
            print(f"port (CPU), {stage} stage, worst of {args.rigs} rigs: {tra!r} m, {rot!r} deg")
    if args.bundle:
        for port in (False, True) if args.port else (False,):
            tra, rot = worst_bundle_lane(port)
            print(f"{'port' if port else 'JAX reference'} (CPU), config 5, worst of {chip_smoke.BUNDLE_RIGS} lanes: "
                  f"{tra!r} m, {rot!r} deg; the smoke's bound {chip_smoke.BUNDLE_TOL_M} m, "
                  f"{chip_smoke.BUNDLE_TOL_DEG} deg ({chip_smoke.BUNDLE_TOL_M / tra:.2f}x, "
                  f"{chip_smoke.BUNDLE_TOL_DEG / rot:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
