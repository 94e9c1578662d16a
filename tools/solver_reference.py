#!/usr/bin/env python3
"""The JAX reference's own worst lane on the planar-pose, semi-DLT and
Scheimpflug stereo and bundle cells of ``chip_smoke.py``: the basis of its
PLANAR_TOL, SEMIDLT_TOL, and the Scheimpflug cells' POSE_TOL and
BUNDLE_TOL checks.

    JAX_PLATFORMS=cpu python3 tools/solver_reference.py [--cells planar,semidlt,stereo,bundle] [--port]

Builds each cell's set with the smoke's own generators (held equal to the
JAX package's recipes by tests/test_torch_smoke.py), solves it with the JAX
package on the CPU as the smoke calls the port (planar_pose_batch; the
Zhang seed and a vmapped optimize_intrinsics_semidlt_device; extrinsics_batch
and a vmapped optimize_bundle_device with the Scheimpflug model) and prints
the worst lane's error against the truth beside the smoke's bound. With
``--port`` the port does the same on the CPU. Needs JAX, so it runs beside
the repository's tests, not on the card.
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


def planar(port: bool):
    obj, uv, kmtx, truth = chip_smoke.planar_problems(chip_smoke.PLANAR_CAMERAS)
    if port:
        import torch

        out = chip_smoke.batched.planar_pose_batch(*(torch.as_tensor(a) for a in (obj, uv, kmtx)),
                                                   options=chip_smoke.PLANAR_OPTS)
        ok, pose = bool(out[0].success.all()), out[1].numpy()
    else:
        from calibration_tpu.optim import OptimOptions
        from calibration_tpu.parallel import batched

        out = batched.planar_pose_batch(obj, uv, kmtx, options=OptimOptions(max_iterations=50))
        ok, pose = bool(np.asarray(out[0].success).all()), np.asarray(out[1])
    tra, rot = chip_smoke.pose_errors(pose, truth)
    return ok, f"pose {tra!r} m, {rot!r} deg; the smoke's bound {chip_smoke.PLANAR_TOL_M} m, " \
               f"{chip_smoke.PLANAR_TOL_DEG} deg ({chip_smoke.PLANAR_TOL_M / tra:.2f}x, " \
               f"{chip_smoke.PLANAR_TOL_DEG / rot:.2f}x)"


def semidlt(port: bool):
    obj, uv, intr = chip_smoke.make_problems(chip_smoke.SEMIDLT_CAMERAS)
    if port:
        import torch

        out = chip_smoke.semidlt_solve(torch.as_tensor(obj), torch.as_tensor(uv))
        ok, k, d = bool(out[0].success.all()), out[1].numpy(), out[2].numpy()
    else:
        import jax
        import jax.numpy as jnp

        from calibration_tpu.ops import intrinsics_linear
        from calibration_tpu.optim import IntrinsicsOptimOptions, OptimOptions, semidlt as jsd

        kmtx = jax.vmap(intrinsics_linear.estimate_intrinsics)(jnp.asarray(obj), jnp.asarray(uv)).kmtx
        kmtx = kmtx.at[:, 4].set(0.0)
        opts = IntrinsicsOptimOptions(core=OptimOptions(max_iterations=60))
        out = jax.jit(jax.vmap(lambda o, u, k: jsd.optimize_intrinsics_semidlt_device(o, u, k, opts=opts)))(
            jnp.asarray(obj), jnp.asarray(uv), kmtx)
        ok, k, d = bool(np.asarray(out[0].success).all()), np.asarray(out[1]), np.asarray(out[2])
    k_err = float(np.abs(k[:, :4] - intr[:4]).max())
    d_err = [float(e) for e in np.abs(d[:, :2] - intr[5:7]).max(axis=0)]
    return ok, f"fx, fy, cx, cy {k_err!r} px, k1 {d_err[0]!r}, k2 {d_err[1]!r}; the smoke's bound " \
               f"{chip_smoke.SEMIDLT_TOL_PX} px, {chip_smoke.SEMIDLT_TOL_K} ({chip_smoke.SEMIDLT_TOL_PX / k_err:.2f}x, " \
               f"{chip_smoke.SEMIDLT_TOL_K[0] / d_err[0]:.2f}x, {chip_smoke.SEMIDLT_TOL_K[1] / d_err[1]:.2f}x)"


def stereo(port: bool):
    p = chip_smoke.stereo_problems(chip_smoke.STEREO_RIGS, tilt_tau=chip_smoke.SOLVER_TILT)
    args = [p[k] for k in ("obj", "uv", "intr0", "c0", "r0")]
    if port:
        import torch

        out = chip_smoke.extrinsics_batch(*(torch.as_tensor(a) for a in args), opts=chip_smoke.STEREO_SCHEIM_OPTS,
                                          model_name=chip_smoke.SCHEIM_NAME)
        ok, c = bool(out[0].success.all()), out[2].numpy()
    else:
        from calibration_tpu.optim import ExtrinsicOptions, OptimOptions
        from calibration_tpu.parallel import batched

        opts = ExtrinsicOptions(core=OptimOptions(max_iterations=50, compute_covariance=False),
                                optimize_intrinsics=False)
        out = batched.extrinsics_batch(*args, opts=opts, model_name=chip_smoke.SCHEIM_NAME)
        ok, c = bool(np.asarray(out[0].success).all()), np.asarray(out[2])
    tra, rot = chip_smoke.pose_errors(c[:, 1], p["rel_gt"])
    return ok, f"camera 1 {tra!r} m, {rot!r} deg; the smoke's bound {chip_smoke.POSE_TOL_M} m, " \
               f"{chip_smoke.POSE_TOL_DEG} deg"


def bundle(port: bool):
    p = chip_smoke.bundle_problems(chip_smoke.BUNDLE_RIGS, tilt_tau=chip_smoke.SOLVER_TILT)
    if port:
        out = chip_smoke.optimize_bundle_device(*chip_smoke.bundle_args(p, "cpu"), model=chip_smoke.SCHEIMPFLUG,
                                                opts=chip_smoke.BUNDLE_OPTS)
        ok, g = bool(out[0].success.all()), out[2][:, 0].numpy()
    else:
        import jax
        import jax.numpy as jnp

        from calibration_tpu.models.registry import SCHEIMPFLUG
        from calibration_tpu.optim import BundleOptions, OptimOptions, bundle as jb

        opts = BundleOptions(core=OptimOptions(max_iterations=50, compute_covariance=False))
        args = [a.numpy() for a in chip_smoke.bundle_args(p, "cpu")]
        out = jax.jit(jax.vmap(lambda *a: jb.optimize_bundle_device(*a, model=SCHEIMPFLUG, opts=opts)))(
            *(jnp.asarray(a) for a in args))
        ok, g = bool(np.asarray(out[0].success).all()), np.asarray(out[2])[:, 0]
    tra, rot = chip_smoke.pose_errors(g, p["g_gt"])
    return ok, f"g_se3_c {tra!r} m, {rot!r} deg; the smoke's bound {chip_smoke.BUNDLE_TOL_M} m, " \
               f"{chip_smoke.BUNDLE_TOL_DEG} deg ({chip_smoke.BUNDLE_TOL_M / tra:.2f}x, " \
               f"{chip_smoke.BUNDLE_TOL_DEG / rot:.2f}x)"


CELLS = {"planar": planar, "semidlt": semidlt, "stereo": stereo, "bundle": bundle}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cells", default=",".join(CELLS))
    parser.add_argument("--port", action="store_true", help="also run the port on the CPU")
    args = parser.parse_args()
    for name in args.cells.split(","):
        for port in (False, True) if args.port else (False,):
            t0 = time.perf_counter()
            ok, text = CELLS[name](port)
            print(f"{'port' if port else 'JAX reference'} (CPU), {name}: every lane converged {ok}; worst lane "
                  f"{text} [{time.perf_counter() - t0:.1f} s]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
