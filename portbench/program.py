"""What every entry does with the program: build its native parts, run an
app's ``main`` quietly, derive per-fleet seeds.

The program (``calibration_tpu_torch``) is imported inside the functions,
so that the benchmark's modules import without it.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np


def build(device: str) -> None:
    """Build or load the program's native parts before the first call: K1
    (nvcc, on the card) and the detections codec and JSON writer (g++), in
    ``build/`` inside the checkout."""
    from calibration_tpu_torch import native

    if device == "cuda":
        from calibration_tpu_torch.kernels import _build

        _build.load_library()
    native.get_lib()
    native.dumps_fast({"warm": [1.0]})


def fleet_seed(seed: int, fleet: int, stream: int = 0) -> list:
    """The entropy of fleet ``fleet``'s random stream ``stream``."""
    return [int(seed), int(fleet), int(stream)]


def run_main(main, argv) -> None:
    """Call an app's ``main(argv)`` with its output captured; raise with the
    end of that output when it does not exit 0."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = main(argv)
    if rc != 0:
        raise RuntimeError(f"{main.__module__} exited {rc}: {log.getvalue()[-2000:]}")


def worst(values) -> float:
    """The largest of ``values`` as a float; NaN or an infinity reads as
    infinity (a number that is not there has failed)."""
    arr = np.asarray([float(v) for v in values], dtype=float)
    if arr.size == 0:
        return float("inf")
    arr = np.where(np.isfinite(arr), arr, np.inf)
    return float(arr.max())
