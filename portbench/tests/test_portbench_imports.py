"""What the benchmark imports: never JAX, the JAX package or its benchmark
code; and the reference nothing of the program. Each check runs in a fresh
interpreter and compares the top-level names of sys.modules whole (the
port's name begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench import manifest

FORBIDDEN = ["jax", "jaxlib", "flax", "calibration_tpu", "benchmarks", "bench", "bench_all", "chip_smoke"]


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.partition('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, check=True, cwd=manifest.ROOT, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_and_its_parts_import_no_jax():
    bench = manifest.benchmark()
    loads = ["import runpy, sys", "sys.argv = ['portbench/run.py']",
             "mod = runpy.run_path('portbench/run.py', run_name='portbench_run')",
             "from portbench import manifest, control"]
    for w in bench["workloads"]:
        loads.append(f"manifest.module('entries', manifest.workload({w['name']!r})['entry'])")
    for section, kind in (("end_to_end", "end_to_end"), ("per_layer", "layers")):
        for m in bench[section]:
            loads.append(f"manifest.module({kind!r}, {m['name']!r})")
    names = _top_level("\n".join(loads))
    assert "torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_a_run_on_the_cpu_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from pathlib import Path\n"
        "from portbench.tests.helpers import tiny_copy, run_tiny\n"
        f"here = tiny_copy(Path({str(tmp_path)!r}))\n"
        "for cell in ('planar-fleet.app-256', 'robot-cell.pipeline-64'):\n"
        "    run_tiny(here, cell, 5, seconds=0.5)\n"
    )
    names = _top_level(code)
    assert "calibration_tpu_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    names = _top_level("import portbench.reference.planar, portbench.reference.bundle, portbench.gen")
    assert not names & {"calibration_tpu_torch", *FORBIDDEN}
