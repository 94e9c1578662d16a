#!/usr/bin/env python3
"""The spreads a bound is set from, read from saved result lines.

    python3 portbench/spread.py DIR

DIR holds one file per run, ``<cell>.<set>.<seed>.out``, whose last line
is a run's result line, ``<set>`` A or B for two sets of runs on the same
seeds. For each cell and end-to-end metric it prints each set's quartile
spread (the distance between the first and third quartile of
``statistics.quantiles(values, n=4)``, over the median), the mean of the
two sets' spreads with each set's run farthest from its median left out
(a bound is too tight when this passes half of it), the spread of all
runs (a bound is too loose when it passes eight times this), and the two
sets' medians.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def without_farthest(values) -> list:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]


def main(argv=None) -> int:
    directory = Path((argv or sys.argv[1:])[0])
    runs = {}
    for path in sorted(directory.glob("*.out")):
        cell, kind = path.name.rsplit(".", 3)[0], path.name.rsplit(".", 3)[1]
        lines = path.read_text().strip().splitlines()
        if kind not in ("A", "B") or not lines:
            continue
        for name, m in json.loads(lines[-1])["metrics"].items():
            runs.setdefault((cell, name), {}).setdefault(kind, []).append(m["value"])
    for (cell, name), sets in sorted(runs.items()):
        if set(sets) != {"A", "B"} or min(len(v) for v in sets.values()) < 4:
            continue
        a, b = sets["A"], sets["B"]
        tight = statistics.mean(spread(without_farthest(v)) for v in (a, b))
        print(f"{cell} {name}: set spreads {spread(a):.4f} {spread(b):.4f}; tightness reading {tight:.4f}; "
              f"all runs {spread(a + b):.4f}; medians {statistics.median(a)!r} {statistics.median(b)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
