"""A later PR adds a cell, a configuration, an entry and a per-layer metric
as new files and new manifest entries, with no edit to a file that is
there: shown with a throwaway cell in a copy."""

from __future__ import annotations

import hashlib
import json

from portbench import manifest
from portbench.tests.helpers import run_tiny, tiny_copy

LAYER = '''
def read(run):
    return float(run.calls)
'''


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_by_new_files_only(tmp_path):
    here = tiny_copy(tmp_path)
    before = _digests(here)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # new files: a configuration, a cell, an entry and a per-layer metric
    cfg = manifest.config("planar-fleet", here)
    cfg.update(name="planar-fleet-8views", shapes=dict(cfg["shapes"], views=8))
    (here / "configs" / "planar-fleet-8views.json").write_text(json.dumps(cfg))
    wl = manifest.workload("planar-fleet.batch-256", here)
    wl.update(name="planar-fleet-8views.batch-4", config="planar-fleet-8views", entry="facade_batch_copy")
    (here / "workloads" / "planar-fleet-8views.batch-4.json").write_text(json.dumps(wl))
    (here / "entries" / "facade_batch_copy.py").write_text(
        "from portbench import manifest\n"
        "_base = manifest.module('entries', 'facade_batch')\n"
        "Entry = _base.Entry\n")
    (here / "layers" / "window.calls.py").write_text(LAYER)
    # new manifest entries
    bench["configs"].append({"name": "planar-fleet-8views", "source": "https://example.org/x", "reduced": [],
                             "file": "portbench/configs/planar-fleet-8views.json", "why": "throwaway"})
    bench["workloads"].append({"name": wl["name"], "config": wl["config"], "traffic": "batch-4", "chips": 1,
                               "why": "throwaway"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(wl["name"])
    bench["per_layer"].append({"name": "window.calls", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "solves_per_s",
                               "workloads": [wl["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before, "an existing file changed"
    out = run_tiny(here, wl["name"], 99)
    assert out["correct"] and out["attempted"] % 4 == 0
    assert set(out["metrics"]) >= {"solves_per_s", "setup_s"}
    out = run_tiny(here, wl["name"], 99, trace=True)
    assert out["metrics"]["window.calls"]["value"] >= 2
