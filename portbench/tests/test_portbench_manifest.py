"""BENCHMARK.json against the benchmark's contract, and every part it names
found by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import manifest

BENCH = manifest.benchmark()
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = 24
    check_s = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert check_s <= 43200, "run_seconds would not fit a full check of 24 cells"


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert manifest.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert manifest.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["source"].startswith("https://") and LINE.match(c["source"])
        assert PATH.match(c["file"]) and c["file"].startswith("portbench/")
        assert c["file"] not in files
        files.add(c["file"])
        assert (manifest.ROOT / c["file"]).is_file()
        data = json.loads((manifest.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16


def test_workloads_found_by_name():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and manifest.NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        data = manifest.workload(w["name"])
        assert data["name"] == w["name"] and data["config"] == w["config"] and data["why"] == w["why"]
        manifest.config(data["config"])
        entry = manifest.module("entries", data["entry"])
        for attr in ("spans", "call", "outcome", "counters", "judge", "control"):
            assert hasattr(entry.Entry, attr), (data["entry"], attr)
        assert data["checks"], "every cell compares some number"
        for limit in data["checks"].values():
            assert limit is not None and limit >= 0, f"{w['name']}: a limit is not set"
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_found_by_name():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        assert callable(manifest.module("end_to_end", m["name"]).read)
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert callable(manifest.module("layers", m["name"]).read)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_roofline_names():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_files_under_paths_are_named_from_names():
    for path in manifest.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(manifest.ROOT).as_posix()
        assert PATH.match(rel), rel
