#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's dense-LM, line-scan and
Scheimpflug cells, on one CUDA card: config1-b8192 (``homography_batch``),
config4-b256 (``handeye_batch``), config5-b128 (``bundle_batch``),
handeye-pipeline-64 (``bundle_pipeline`` without a bundle section),
bundle-pipeline-64 (``bundle_pipeline`` with it: intrinsics, hand-eye,
bundle), linescan-b1024 (row 5L, ``linescan_batch``),
linescan-ransac-b256 and linescan-scheimpflug-b256 (rows 5R and 5S,
``linescan_ransac_batch``), scheimpflug-b256 and scheimpflug-tilt-b256
(rows 2S and 2T, ``intrinsics_batch`` with the Scheimpflug model),
planar-pose-b2560 (``planar_pose_batch``), semidlt-b256
(``optimize_intrinsics_semidlt_device``), stereo-scheimpflug-b128
(``extrinsics_batch`` with the Scheimpflug model) and
bundle-scheimpflug-b128 (``optimize_bundle_device`` with it), each with
the data of ``chip_smoke.py``.

    python3 tools/profile_torch_cells.py [--repeats 7] [--out DIR] [--cells a,b] [--sweeps a,b]

First the first-phase cap sweeps: of the homography batch (caps 2-6), of
the bundle batch (caps 2-6 and 12, the reference's), and of the Scheimpflug
intrinsics with fixed distortion indices (row 2S's set, caps 6-20) and with
every coefficient free (2S's set with p1 and p2 free, caps 10-40):
``repeats`` warm calls per cap and in one phase, interleaved in the order A
B .. Z Z .. A, with the median per cap. Then the A/B of the Scheimpflug
per-view Jacobian (rows 2S and 2T): ``lm_schur.view_jacobian_fn``, one
dual-number pass over the batch repeated pg + 6 times, against the port's
other forward-mode idiom, a ``torch.func.vmap`` over (B, V) of ``jacfwd``
(``vmap_jacfwd_view_jacobian_fn`` below), interleaved the same way, and
the A/B of the manifold retraction (semi-DLT and the Scheimpflug stereo
cell: runs of one block kind retracted together against block by block),
and the mesh sweep (config 2 at B = 254 through ``intrinsics_facade_batch``
on 4 shards of one card: the four shards one after another on one thread,
as the port runs the shards of one device; a host thread per shard, as it
runs the shards of distinct devices; the same with the interpreter's
switch interval at 0.1 ms; and the unsharded single-phase call). Then each
cell's warm wall times (host clock, synchronized); then, after every timed call, one warm call of each cell
under ``torch.profiler`` (device kernel time by name, the device's idle
share of the profiled wall) and one under cProfile (host functions by
cumulative time). ``--cells`` and ``--sweeps`` pick some by name
(default all). Prints one line per result, and the profiler and cProfile
tables into ``--out``. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import cProfile
import functools
import io
import pstats
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import dataclasses  # noqa: E402

import chip_smoke  # noqa: E402
from calibration_tpu_torch.ops import ransac  # noqa: E402
from calibration_tpu_torch.models.registry import SCHEIMPFLUG  # noqa: E402
from calibration_tpu_torch.ops import se3  # noqa: E402
from calibration_tpu_torch.optim import lm_schur, optimize_bundle_device  # noqa: E402
from calibration_tpu_torch.optim.manifold import ProductManifold  # noqa: E402
from calibration_tpu_torch.parallel import batched, bundle_batch, handeye_batch, homography_batch  # noqa: E402
from calibration_tpu_torch.parallel import intrinsics_batch, intrinsics_facade_batch, linescan_batch  # noqa: E402
from calibration_tpu_torch.parallel import linescan_ransac_batch, make_mesh  # noqa: E402


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def device_profile(fn, name, out_dir):
    """(profiled wall s, device kernel s, top kernels) of one call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = synced(fn)
    # the device's own events (kernels, copies): operators only launch them
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name][0] += 1
            kernels[e.name][1] += e.time_range.elapsed_us()
    kernel_us = sum(us for _, us in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    (out_dir / f"{name}_profiler.txt").write_text(
        prof.key_averages().table(sort_by="device_time_total", row_limit=40)
    )
    return wall, kernel_us / 1e6, [(k[:70], n, us / 1e3) for k, (n, us) in top]


def host_profile(fn, name, out_dir):
    """cProfile of one call: the top host functions by cumulative time."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    buf = io.StringIO()
    stats = pstats.Stats(prof, stream=buf).sort_stats("cumulative")
    stats.print_stats(40)
    (out_dir / f"{name}_cprofile.txt").write_text(buf.getvalue())
    return stats.total_tt


def warm_walls(name, fn, repeats, card):
    fn()  # first call
    walls = [synced(fn) for _ in range(repeats)]
    print(f"[profile] {name}: warm walls {walls!r} s (median {statistics.median(walls)!r}) on {card}")


def report(name, fn, out_dir):
    wall, kernel_s, top = device_profile(fn, name, out_dir)
    print(f"[profile] {name}: profiled wall {wall!r} s, device kernel time {kernel_s!r} s, "
          f"device idle {1 - kernel_s / wall!r}; top kernels (name, launches, ms): {top!r}")
    print(f"[profile] {name}: cProfile host total {host_profile(fn, name, out_dir)!r} s "
          f"(table in {out_dir / (name + '_cprofile.txt')})")


def cap_sweep(name, fn, attr, caps, repeats):
    """Warm walls of ``fn(two_phase=...)`` at each first-phase cap (the
    module constant ``attr`` of batched) and in one phase (None),
    interleaved A B .. Z Z .. A; prints the median per setting."""
    caps = tuple(caps) + (None,)
    times = {c: [] for c in caps}
    saved = getattr(batched, attr)
    fn()
    for order in range(repeats):
        for cap in (caps if order % 2 == 0 else caps[::-1]):
            if cap is not None:
                setattr(batched, attr, cap)
            times[cap].append(synced(functools.partial(fn, two_phase=cap is not None)))
    setattr(batched, attr, saved)
    for cap in caps:
        label = "one phase" if cap is None else f"cap {cap}"
        print(f"[profile] {name} {label}: median {statistics.median(times[cap])!r} s, all {times[cap]!r}")


def vmap_jacfwd_view_jacobian_fn(residual_fn):
    """``lm_schur.view_jacobian_fn``'s Jacobian by ``torch.func.vmap`` over
    (B, V) of ``jacfwd`` of one view's retracted residual at zero tangent,
    the idiom of ``lm.tangent_jacobian``."""

    def jac_fn(xg, quats, trans, *view_data):
        pg = xg.shape[-1]

        def one(delta, g, q, t, *data):
            qn, tn = lm_schur._retract_views(q[None, None], t[None, None], delta[None, None, pg:])
            return residual_fn((g + delta[:pg])[None], qn, tn, *(d[None, None] for d in data))[0, 0]

        dims = (0,) * len(view_data)
        per_view = torch.func.vmap(torch.func.jacfwd(one), in_dims=(None, None, 0, 0) + dims)
        lanes = torch.func.vmap(per_view, in_dims=(None, 0, 0, 0) + dims)
        return lanes(xg.new_zeros(pg + 6), xg, quats, trans, *view_data)

    return jac_fn


def jacobian_ab(name, fn, repeats):
    """Warm walls of ``fn`` with each per-view Jacobian builder swapped in,
    interleaved A B B A; prints the median per builder and the cost
    difference between the two results."""
    builders = {"dual": lm_schur.view_jacobian_fn, "vmap-jacfwd": vmap_jacfwd_view_jacobian_fn}
    times, costs = {k: [] for k in builders}, {}
    try:
        for key, builder in builders.items():
            lm_schur.view_jacobian_fn = builder
            costs[key] = fn()[1][0].cost  # first call
        for order in range(repeats):
            for key in (builders if order % 2 == 0 else list(builders)[::-1]):
                lm_schur.view_jacobian_fn = builders[key]
                times[key].append(synced(fn))
    finally:
        lm_schur.view_jacobian_fn = builders["dual"]
    rel = float(((costs["dual"] - costs["vmap-jacfwd"]).abs() / costs["dual"].abs().clamp(min=1e-300)).max())
    for key in builders:
        print(f"[profile] {name} jacobian {key}: median {statistics.median(times[key])!r} s, all {times[key]!r}")
    print(f"[profile] {name} jacobian: max relative cost difference dual vs vmap-jacfwd {rel!r}")


def per_block_retract(self, x, delta):
    """``ProductManifold.retract`` block by block, as before the runs of
    one kind were retracted together (the A/B's other arm)."""
    parts = []
    for kind, sa, st in self._segments:
        if kind == "euclid":
            parts.append(x[..., sa] + delta[..., st])
        else:
            qn = se3.quat_mul(x[..., sa], se3.exp_quat(delta[..., st]))
            parts.append(qn / torch.linalg.norm(qn, dim=-1, keepdim=True))
    return torch.cat(parts, dim=-1)


def retract_ab(name, fn, repeats):
    """Warm walls of ``fn`` with the run-wise and the per-block retract,
    interleaved A B B A; prints the median per arm and the cost
    difference between the two results."""
    arms = {"runs": ProductManifold.retract, "per-block": per_block_retract}
    times, costs = {k: [] for k in arms}, {}
    try:
        for key, impl in arms.items():
            ProductManifold.retract = impl
            costs[key] = fn()[0].cost  # first call
        for order in range(repeats):
            for key in (arms if order % 2 == 0 else list(arms)[::-1]):
                ProductManifold.retract = arms[key]
                times[key].append(synced(fn))
    finally:
        ProductManifold.retract = arms["runs"]
    rel = float(((costs["runs"] - costs["per-block"]).abs() / costs["runs"].abs().clamp(min=1e-300)).max())
    for key in arms:
        print(f"[profile] {name} retract {key}: median {statistics.median(times[key])!r} s, all {times[key]!r}")
    print(f"[profile] {name} retract: max relative cost difference runs vs per-block {rel!r}")


@contextlib.contextmanager
def thread_per_shard():
    """``batched._on_mesh`` with a host thread per shard, as on a mesh of
    distinct cards (the mesh sweep's arm)."""
    by_device = batched._by_device
    batched._by_device = lambda devices: [[i] for i in range(len(devices))]
    try:
        yield
    finally:
        batched._by_device = by_device


@contextlib.contextmanager
def switch_interval(seconds):
    prev = sys.getswitchinterval()
    sys.setswitchinterval(seconds)
    try:
        yield
    finally:
        sys.setswitchinterval(prev)


def mesh_sweep(name, sharded, unsharded, repeats):
    """Warm walls of a 4-shard mesh call of one card on one thread (the
    port), with a thread per shard, the same with a 0.1 ms switch
    interval, and of the unsharded call, interleaved A B C D D C B A;
    prints the median per arm."""

    @contextlib.contextmanager
    def threads_fast_switch():
        with thread_per_shard(), switch_interval(1e-4):
            yield

    arms = {"one thread": (sharded, contextlib.nullcontext), "threads": (sharded, thread_per_shard),
            "threads, 0.1 ms switch": (sharded, threads_fast_switch),
            "unsharded single phase": (unsharded, contextlib.nullcontext)}
    times = {k: [] for k in arms}
    for key, (fn, ctx) in arms.items():
        with ctx():
            fn()  # first call
    for order in range(repeats):
        for key in (arms if order % 2 == 0 else list(arms)[::-1]):
            fn, ctx = arms[key]
            with ctx():
                times[key].append(synced(fn))
    for key in arms:
        print(f"[profile] {name} mesh {key}: median {statistics.median(times[key])!r} s, all {times[key]!r}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=7)
    parser.add_argument("--out", default=str(ROOT / "build" / "profile"))
    parser.add_argument("--cells", default="", help="comma-separated cell names (default all)")
    parser.add_argument("--sweeps", default="", help="comma-separated sweeps: homography, bundle, "
                        "scheimpflug-fixed, scheimpflug-free, jacobian, retract, mesh (default all)")
    args = parser.parse_args()
    picked = lambda arg, name: not arg or name in arg.split(",")  # noqa: E731
    if not torch.cuda.is_available():
        print("profile_torch_cells: no CUDA device", file=sys.stderr)
        return 1
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda:0")
    card = chip_smoke.card_line()
    print(f"[profile] card (name, power limit): {card}")

    _, src, dst = chip_smoke.homography_problems(chip_smoke.HOMOG_LANES)
    s_d, d_d = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
    homog = functools.partial(homography_batch, s_d, d_d, options=chip_smoke.HOMOG_OPTS)
    _, bg, ct = chip_smoke.handeye_problems(chip_smoke.HANDEYE_RIGS)
    he = functools.partial(handeye_batch, torch.as_tensor(bg, device=dev), torch.as_tensor(ct, device=dev),
                           options=chip_smoke.HANDEYE_OPTS)

    bundle = functools.partial(bundle_batch, *chip_smoke.bundle_args(chip_smoke.bundle_problems(chip_smoke.BUNDLE_RIGS),
                                                                      dev), opts=chip_smoke.BUNDLE_OPTS)
    on_card = lambda arrays: [torch.as_tensor(a, device=dev) for a in arrays]  # noqa: E731
    line = functools.partial(linescan_batch, *on_card(chip_smoke.linescan_problems(chip_smoke.LINESCAN_RIGS)[:4]))
    ropts = ransac.RansacOptions(**chip_smoke.LINESCAN_RANSAC_OPTS)
    line_r = functools.partial(linescan_ransac_batch, *on_card(chip_smoke.linescan_ransac_problems("5R", None)[:4]),
                               options=ropts)
    line_s = functools.partial(
        linescan_ransac_batch, *on_card(chip_smoke.linescan_ransac_problems("5S", chip_smoke.LINESCAN_TILT)[:4]),
        options=ropts, model_name=chip_smoke.SCHEIM_NAME)
    scheim = {}
    for row in ("2S", "2T"):
        obj, uv, _ = chip_smoke.scheimpflug_problems(chip_smoke.SCHEIM_RIGS, chip_smoke.SCHEIM_ROWS[row][0])
        scheim[row] = functools.partial(intrinsics_batch, *on_card((obj, uv)), opts=chip_smoke.scheimpflug_opts(row),
                                        model_name=chip_smoke.SCHEIM_NAME)
    free = dataclasses.replace(chip_smoke.scheimpflug_opts("2S"), fixed_distortion_indices=())
    scheim_free = functools.partial(scheim["2S"], opts=free)
    planar = functools.partial(batched.planar_pose_batch,
                               *on_card(chip_smoke.planar_problems(chip_smoke.PLANAR_CAMERAS)[:3]),
                               options=chip_smoke.PLANAR_OPTS)
    semidlt = functools.partial(chip_smoke.semidlt_solve,
                                *on_card(chip_smoke.make_problems(chip_smoke.SEMIDLT_CAMERAS)[:2]))
    stereo_p = chip_smoke.stereo_problems(chip_smoke.STEREO_RIGS, tilt_tau=chip_smoke.SOLVER_TILT)
    stereo_s = functools.partial(chip_smoke.extrinsics_batch,
                                 *on_card([stereo_p[k] for k in ("obj", "uv", "intr0", "c0", "r0")]),
                                 opts=chip_smoke.STEREO_SCHEIM_OPTS, model_name=chip_smoke.SCHEIM_NAME)
    bundle_s = functools.partial(
        optimize_bundle_device,
        *chip_smoke.bundle_args(chip_smoke.bundle_problems(chip_smoke.BUNDLE_RIGS, tilt_tau=chip_smoke.SOLVER_TILT), dev),
        model=SCHEIMPFLUG, opts=chip_smoke.BUNDLE_OPTS)

    # the cap sweeps first, before any profiler has run in this process
    for name, label, fn, attr, caps in (
        ("homography", f"homography B={chip_smoke.HOMOG_LANES}", homog, "HOMOG_PHASE_CAP", range(2, 7)),
        ("bundle", f"bundle B={chip_smoke.BUNDLE_RIGS}", bundle, "BUNDLE_PHASE_CAP", (2, 3, 4, 5, 6, 12)),
        ("scheimpflug-fixed", f"Scheimpflug 2S (p1, p2 fixed) B={chip_smoke.SCHEIM_RIGS}", scheim["2S"],
         "SCHEIMPFLUG_PHASE_CAP_FIXED", (6, 8, 10, 12, 15, 20)),
        ("scheimpflug-free", f"Scheimpflug 2S set, every coefficient free, B={chip_smoke.SCHEIM_RIGS}", scheim_free,
         "SCHEIMPFLUG_PHASE_CAP_FREE", (10, 15, 20, 30, 40)),
    ):
        if picked(args.sweeps, name):
            cap_sweep(label, fn, attr, caps, args.repeats)
    if picked(args.sweeps, "jacobian"):
        for row in ("2S", "2T"):
            jacobian_ab(f"Scheimpflug {row} B={chip_smoke.SCHEIM_RIGS}", scheim[row], args.repeats)
    if picked(args.sweeps, "retract"):
        retract_ab(f"semi-DLT B={chip_smoke.SEMIDLT_CAMERAS}", semidlt, max(3, args.repeats // 2))
        retract_ab(f"Scheimpflug stereo B={chip_smoke.STEREO_RIGS}", stereo_s, args.repeats)

    obj, uv, _ = chip_smoke.make_problems(chip_smoke.MESH_FACADE_CAMERAS)
    facade = functools.partial(intrinsics_facade_batch, *on_card((obj, uv)), opts=chip_smoke.FACADE_OPTS)
    mesh4 = functools.partial(facade, mesh=make_mesh([dev] * chip_smoke.MESH_SHARDS))
    if picked(args.sweeps, "mesh"):
        mesh_sweep(f"config 2 B={chip_smoke.MESH_FACADE_CAMERAS}, {chip_smoke.MESH_SHARDS} shards of one card",
                   mesh4, functools.partial(facade, two_phase=False), args.repeats)

    with tempfile.TemporaryDirectory() as tmp:
        fleet = chip_smoke.write_handeye_fleet(Path(tmp), chip_smoke.HE_PIPELINE_RIGS)
        handeye_input = chip_smoke.pipeline_variant(fleet["input_path"], "handeye")

        def pipeline(input_path):
            from calibration_tpu_torch.apps import bundle_pipeline

            with contextlib.redirect_stdout(io.StringIO()):
                rc = bundle_pipeline.main(["--input", input_path, "--output", str(Path(tmp) / "a.json"),
                                           "--device", "cuda"])
            assert rc == 0

        cells = [(name, fn) for name, fn in (
            ("config1-b8192", homog), ("config4-b256", he), ("config5-b128", bundle),
            ("handeye-pipeline-64", functools.partial(pipeline, handeye_input)),
            ("bundle-pipeline-64", functools.partial(pipeline, fleet["input_path"])),
            ("linescan-b1024", line), ("linescan-ransac-b256", line_r), ("linescan-scheimpflug-b256", line_s),
            ("scheimpflug-b256", scheim["2S"]), ("scheimpflug-tilt-b256", scheim["2T"]),
            ("planar-pose-b2560", planar), ("semidlt-b256", semidlt), ("stereo-scheimpflug-b128", stereo_s),
            ("bundle-scheimpflug-b128", bundle_s), ("mesh-4-shards-config2-b254", mesh4),
        ) if picked(args.cells, name)]
        # every timed call before the first profiler (it slows later launches)
        for name, fn in cells:
            warm_walls(name, fn, args.repeats, card)
        for name, fn in cells:
            report(name, fn, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
