"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

All ``csrc/*.cu`` sources compile into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <lib> csrc/*.cu

at first use, into ``build/calibration_tpu_torch/<hash of the sources>/``
beside the package. A missing nvcc or a failed build raises. A launcher
takes the address of its argument struct and the CUDA stream, both as
``c_void_p``, and returns ``cudaGetLastError()`` as ``c_int``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "calibration_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC",
)
_DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
_load_lock = threading.Lock()  # a mesh's device threads may all load it at once


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if _DEFAULT_NVCC.is_file():
        return str(_DEFAULT_NVCC)
    raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin: cannot build the CUDA kernels")


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def cached_output(root: Path, name: str, flags, sources, key: str = "") -> Path:
    """Where the output ``name`` of these flags, sources and ``key`` lives:
    ``root/<hash of them>/name``."""
    h = hashlib.sha256(" ".join((*flags, key)).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return root / h.hexdigest()[:16] / name


def compile_once(compiler, flags, sources, out: Path) -> Path:
    """Run ``compiler flags -o out sources`` unless ``out`` exists; returns
    ``out``. The output is written to a temporary name and renamed, so
    concurrent builds never load a half-written file. A failed compile
    raises RuntimeError with the compiler's output."""
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [compiler, *flags, "-o", tmp, *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{compiler} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    return cached_output(BUILD_ROOT, "libcalibration_tpu_torch_kernels.so", NVCC_FLAGS, _sources())


def build() -> Path:
    """Compile the sources unless the library for them exists; returns its
    path."""
    return compile_once(_nvcc(), NVCC_FLAGS, _sources(), library_path())


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every launcher's
    signature declared; once per process."""
    with _load_lock:
        return _load_library()


@functools.lru_cache(maxsize=1)
def _load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for fn in (lib.projection_residuals_launch, lib.projection_rms_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
