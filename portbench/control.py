#!/usr/bin/env python3
"""The readings that the limits of a cell's correctness checks are set from.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each of ``--seeds`` it sets the cell up at its own size, runs one call
of the program on each of its fleets (the cell's own load) and judges the
outputs as a run does: the lower readings. For each of
``--control-seeds`` it puts the control in the program's place, the plain
reference computed in the next precision down (float32 for the float64
solves, bfloat16 for the float32 QA RMS; ``Entry.control``), and judges
that: the upper readings. One JSON line per seed; a last line with, for
each compared number, the largest program reading and the smallest
control reading. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import manifest, program  # noqa: E402


def readings(cell: str, seed: int, control: bool, device: str, here: Path = manifest.HERE) -> dict:
    """The compared numbers of one seed: the program's, or the control's."""
    wl = manifest.workload(cell, here)
    cfg = manifest.config(wl["config"], here)
    entry_mod = manifest.module("entries", wl["entry"], here)
    program.build(device)
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as workdir:
        entry = entry_mod.Entry(cfg, wl["traffic"], seed % 2**63, device, Path(workdir))
        if control:
            kept = [entry.control(k) for k in range(entry.fleets)]
        else:
            kept = []
            for k in range(entry.fleets):
                kept.append(entry.call(k))
                if device == "cuda":
                    torch.cuda.synchronize()
        return {name: float(v) for name, v in entry.judge(kept).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("control: no CUDA device", file=sys.stderr)
            return 3
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    lower, upper = {}, {}
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            got = readings(args.workload, seed, side == "control", args.device)
            print(json.dumps({"cell": args.workload, "side": side, "seed": seed, "readings": got,
                              "seconds": time.perf_counter() - t0}), flush=True)
            for name, value in got.items():
                if side == "program":
                    lower[name] = max(lower.get(name, 0.0), value)
                else:
                    upper[name] = min(upper.get(name, float("inf")), value)
    print(json.dumps({"cell": args.workload, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
