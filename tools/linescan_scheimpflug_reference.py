#!/usr/bin/env python3
"""The JAX reference's own errors on the line-scan and Scheimpflug sets of
``chip_smoke.py``: the basis of its LINESCAN_TOL_DEG bounds, and the tilt
statistics beside the 2S / 2T gates.

    JAX_PLATFORMS=cpu python3 tools/linescan_scheimpflug_reference.py [--port] [--skip-intrinsics]

Runs, on the CPU in float64 and as ``bench_all.py`` calls them, the JAX
package's ``linescan_batch`` on row 5L's set (``benchmarks/problems.
linescan_problems(1024)``, seed 23), ``linescan_ransac_batch`` on row 5R's
(B = 256, seed 31, 20% junk laser pixels) and on row 5S's (the same
through the Scheimpflug model, tau = (0.06, -0.04), seed 37), and prints
each one's worst plane-normal angle against the truth and its ``ok``
count beside the smoke's bound. Then ``intrinsics_batch`` with the
Scheimpflug model on rows 2S and 2T (B = 256) and the tilt deviation's
median, p95 and max beside the fixed gates. With ``--port`` the port does
the same on the CPU. Needs JAX, so it runs beside the repository's tests,
not on the card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def linescan_sets():
    """(row, problems, RANSAC options or None, model name) as bench_all.py
    builds them, from the JAX package's generator."""
    from benchmarks import problems

    def with_outliers(seed, tilt):
        camera, obj, tgt_uv, laser_uv, plane = problems.linescan_problems(chip_smoke.LINESCAN_RANSAC_RIGS, seed=seed,
                                                                          tilt_tau=tilt)
        return camera, obj, tgt_uv, chip_smoke.with_laser_outliers(laser_uv, seed), plane

    return (
        ("5L", problems.linescan_problems(chip_smoke.LINESCAN_RIGS), False, chip_smoke.PINHOLE_NAME),
        ("5R", with_outliers(31, None), True, chip_smoke.PINHOLE_NAME),
        ("5S", with_outliers(37, chip_smoke.LINESCAN_TILT), True, chip_smoke.SCHEIM_NAME),
    )


def run_linescan(row, p, use_ransac, model, port):
    camera, obj, tgt_uv, laser_uv, plane_gt = p
    if port:
        import torch

        from calibration_tpu_torch.ops.ransac import RansacOptions
        from calibration_tpu_torch.parallel import batched

        args = [torch.as_tensor(a) for a in (camera, obj, tgt_uv, laser_uv)]
    else:
        from calibration_tpu.ops.ransac import RansacOptions
        from calibration_tpu.parallel import batched

        args = (camera, obj, tgt_uv, laser_uv)
    if use_ransac:
        opts = RansacOptions(**chip_smoke.LINESCAN_RANSAC_OPTS)
        res = batched.linescan_ransac_batch(*args, options=opts, model_name=model)
    else:
        res = batched.linescan_batch(*args, model_name=model)
    plane, ok = np.asarray(res.plane), np.asarray(res.ok)
    return float(chip_smoke.plane_angles_deg(plane, plane_gt).max()), int(ok.sum()), len(ok)


def run_scheimpflug(row, port):
    tilt, opts_kw = chip_smoke.SCHEIM_ROWS[row]
    obj, uv, truth = chip_smoke.scheimpflug_problems(chip_smoke.SCHEIM_RIGS, tilt)
    if port:
        import torch

        from calibration_tpu_torch.optim import IntrinsicsOptimOptions, OptimOptions
        from calibration_tpu_torch.parallel import batched

        obj, uv = torch.as_tensor(obj), torch.as_tensor(uv)
    else:
        from calibration_tpu.optim import IntrinsicsOptimOptions, OptimOptions
        from calibration_tpu.parallel import batched
    core, extra = opts_kw
    opts = IntrinsicsOptimOptions(core=OptimOptions(**core), **extra)
    _, out = batched.intrinsics_batch(obj, uv, opts=opts, model_name=chip_smoke.SCHEIM_NAME)
    intr, view_errors = np.asarray(out[1]), np.asarray(out[3])
    dev = np.abs(intr[:, 10:] - truth[10:])
    return (float(np.median(dev)), float(np.percentile(dev, 95)), float(dev.max()),
            float(np.sqrt(np.mean(view_errors**2))), int(np.asarray(out[0].success).sum()))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--port", action="store_true", help="also run the port on the CPU")
    parser.add_argument("--skip-intrinsics", action="store_true", help="only the line-scan rows")
    args = parser.parse_args()
    who = ("JAX reference", "port") if args.port else ("JAX reference",)
    for row, p, use_ransac, model in linescan_sets():
        bound = chip_smoke.LINESCAN_TOL_DEG[row]
        for name in who:
            t0 = time.perf_counter()
            worst, n_ok, b = run_linescan(row, p, use_ransac, model, name == "port")
            print(f"{name} (CPU), row {row}, {b} rigs: worst plane-normal angle {worst!r} deg, {n_ok} ok; the "
                  f"smoke's bound {bound} deg ({bound / worst:.2f}x); {time.perf_counter() - t0:.1f} s")
    if not args.skip_intrinsics:
        for row in chip_smoke.SCHEIM_ROWS:
            for name in who:
                t0 = time.perf_counter()
                med, p95, mx, rms, n_ok = run_scheimpflug(row, name == "port")
                print(f"{name} (CPU), row {row}, {chip_smoke.SCHEIM_RIGS} lanes: tilt deviation median {med!r}, "
                      f"p95 {p95!r}, max {mx!r} rad (gates {chip_smoke.TILT_GATES}); mean view RMS {rms!r} px; "
                      f"{n_ok} converged; {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
