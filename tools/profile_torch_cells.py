#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's dense-LM cells, on one CUDA
card: config1-b8192 (``homography_batch``), config4-b256
(``handeye_batch``), config5-b128 (``bundle_batch``), handeye-pipeline-64
(``bundle_pipeline`` without a bundle section) and bundle-pipeline-64
(``bundle_pipeline`` with it: intrinsics, hand-eye, bundle), each with the
data of ``chip_smoke.py``.

    python3 tools/profile_torch_cells.py [--repeats 5] [--out DIR]

First the first-phase cap sweeps of the homography batch (caps 2-6) and
of the bundle batch (caps 2-6 and 12, the reference's): ``repeats`` warm
calls per cap and in one phase, interleaved in the order A B .. Z Z .. A,
with the median per cap. Then each cell's warm wall times (host clock,
synchronized); then, after every timed call, one warm call of each cell
under ``torch.profiler`` (device kernel time by name, the device's idle
share of the profiled wall) and one under cProfile (host functions by
cumulative time). Prints one line per result, and the profiler and
cProfile tables into ``--out``. Needs a CUDA device; imports nothing of
JAX.
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

import chip_smoke  # noqa: E402
from calibration_tpu_torch.parallel import batched, bundle_batch, handeye_batch, homography_batch  # noqa: E402


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = parser.parse_args()
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

    # the cap sweeps first, before any profiler has run in this process
    cap_sweep(f"homography B={chip_smoke.HOMOG_LANES}", homog, "HOMOG_PHASE_CAP", range(2, 7), args.repeats)
    cap_sweep(f"bundle B={chip_smoke.BUNDLE_RIGS}", bundle, "BUNDLE_PHASE_CAP", (2, 3, 4, 5, 6, 12), args.repeats)

    with tempfile.TemporaryDirectory() as tmp:
        fleet = chip_smoke.write_handeye_fleet(Path(tmp), chip_smoke.HE_PIPELINE_RIGS)
        handeye_input = chip_smoke.pipeline_variant(fleet["input_path"], "handeye")

        def pipeline(input_path):
            from calibration_tpu_torch.apps import bundle_pipeline

            with contextlib.redirect_stdout(io.StringIO()):
                rc = bundle_pipeline.main(["--input", input_path, "--output", str(Path(tmp) / "a.json"),
                                           "--device", "cuda"])
            assert rc == 0

        cells = (("config1-b8192", homog), ("config4-b256", he), ("config5-b128", bundle),
                 ("handeye-pipeline-64", functools.partial(pipeline, handeye_input)),
                 ("bundle-pipeline-64", functools.partial(pipeline, fleet["input_path"])))
        # every timed call before the first profiler (it slows later launches)
        for name, fn in cells:
            warm_walls(name, fn, args.repeats, card)
        for name, fn in cells:
            report(name, fn, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
