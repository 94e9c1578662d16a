"""The PyTorch port stands alone: no module of calibration_tpu_torch (nor
chip_smoke.py, which runs where JAX is not installed) imports JAX or the
JAX package or builds a path into it, importing any module of the port
loads no JAX module, and the native sources the port builds are its own
copies (byte-identical to the JAX package's today)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "calibration_tpu")
SOURCES = sorted((ROOT / "calibration_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _into_jax_package(node):
    """Whether a string constant names the JAX package as a path: the bare
    directory name, or a path starting with it used in a ``/`` join or as
    an argument of a call (Path, open, os.path.join, ...). A "file:line"
    record such as chip_smoke's "replaces" is neither."""
    if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
        return False
    return node.value.replace("\\", "/").split("/")[0] == "calibration_tpu"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_the_jax_package(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Constant) and node.value == "calibration_tpu":
            bad.append(node.lineno)
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            bad += [n.lineno for n in (node.left, node.right) if _into_jax_package(n)]
        elif isinstance(node, ast.Call):
            bad += [n.lineno for n in node.args if _into_jax_package(n)]
    assert not bad, f"{path.relative_to(ROOT)} builds a path into calibration_tpu/ at lines {bad}"


@pytest.mark.parametrize("name", ["dataset_codec.cpp", "fastjson.cpp"])
def test_native_sources_are_the_ports_own_copies(name):
    from calibration_tpu_torch import native

    port_dir = ROOT / "calibration_tpu_torch"
    assert native._SRC_DIR.is_relative_to(port_dir)
    assert (native._SRC_DIR / name).read_bytes() == (ROOT / "calibration_tpu" / "native" / name).read_bytes()


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in SOURCES
        if p.parent != ROOT
    )
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'calibration_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
