"""Warning capture — the reference redirects std::cerr into a buffer and
counts warning lines to report them (include/calib/io/stream_capture.h:10-23,
used at src/pipeline/facades/intrinsics.cpp:101-113).

The JAX stack is functional: numerical warnings are *returned* as flags, not
printed. This module provides both (a) a contextual collector the facades use
to accumulate warning strings, and (b) an actual stdio capture for parity
with code that prints.

A copy of ``calibration_tpu/io/stream_capture.py``, which is JAX-free but cannot be
imported without importing JAX (``calibration_tpu/__init__.py`` imports it).
"""

from __future__ import annotations

import contextlib
import io
import sys
from typing import List


class WarningCollector:
    """Structured replacement for counting cerr lines."""

    def __init__(self) -> None:
        self.warnings: List[str] = []

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)

    def count_containing(self, needle: str) -> int:
        return sum(1 for w in self.warnings if needle in w)

    def __len__(self) -> int:
        return len(self.warnings)


class StreamCapture(contextlib.AbstractContextManager):
    """RAII-style stdout/stderr capture (stream_capture.h:10-23)."""

    def __init__(self, stream_name: str = "stderr") -> None:
        self._name = stream_name
        self._buffer = io.StringIO()
        self._old = None

    def __enter__(self):
        self._old = getattr(sys, self._name)
        setattr(sys, self._name, self._buffer)
        return self

    def __exit__(self, *exc):
        setattr(sys, self._name, self._old)
        return False

    def str(self) -> str:
        return self._buffer.getvalue()
