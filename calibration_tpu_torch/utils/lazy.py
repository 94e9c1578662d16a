"""Deferred device->host fetches (port of ``calibration_tpu/utils/lazy.py``).

Results that callers usually never read, such as the per-sensor ambient
covariance of the intrinsics fleet (the intrinsics report never writes it),
stay on the device and come back as :class:`LazyDeviceArray`, fetched on
first use. At B = 256 cameras and 80 ambient parameters that batch is 13 MB
of float64 that a report run never copies.

A whole batch shares one :class:`BatchFetcher`: the first access by any lane
copies the full batched tensor to the host with one ``.cpu()``, then every
lane slices host-side numpy (per-lane copies would pay one transfer and one
synchronisation per lane).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import profiling


class BatchFetcher:
    """Holds a device tensor; materializes the whole thing once on demand."""

    __slots__ = ("_device", "_host")

    def __init__(self, device_tensor: torch.Tensor):
        self._device = device_tensor
        self._host: Optional[np.ndarray] = None

    def get(self) -> np.ndarray:
        if self._host is None:
            with profiling.sync("lazy_fetch"):
                self._host = self._device.detach().cpu().numpy()
            self._device = None  # free the device reference
        return self._host


class LazyDeviceArray:
    """One lane of a batched device result, fetched on first use.

    Duck-types the read surface numpy consumers rely on (``np.asarray``,
    ``tolist``, indexing, ``shape``/``dtype``, iteration, arithmetic via
    ``__array__``). ``is not None`` checks behave like a present array.
    """

    __slots__ = ("_fetcher", "_index")

    def __init__(self, fetcher: BatchFetcher, index: Optional[int] = None):
        self._fetcher = fetcher
        self._index = index

    def materialize(self) -> np.ndarray:
        arr = self._fetcher.get()
        return arr if self._index is None else arr[self._index]

    # numpy protocol — np.asarray / ufuncs / allclose all come through here
    def __array__(self, dtype=None, copy=None):
        arr = self.materialize()
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        if copy:
            arr = arr.copy()
        return arr

    def tolist(self):
        return self.materialize().tolist()

    def __getitem__(self, key):
        return self.materialize()[key]

    def __len__(self):
        return len(self.materialize())

    def __iter__(self):
        return iter(self.materialize())

    @property
    def shape(self):
        return self.materialize().shape

    @property
    def dtype(self):
        return self.materialize().dtype

    @property
    def ndim(self):
        return self.materialize().ndim

    def __matmul__(self, other):
        return self.materialize() @ other

    def __rmatmul__(self, other):
        return other @ self.materialize()

    def __add__(self, other):
        return self.materialize() + other

    def __radd__(self, other):
        return other + self.materialize()

    def __sub__(self, other):
        return self.materialize() - other

    def __rsub__(self, other):
        return other - self.materialize()

    def __mul__(self, other):
        return self.materialize() * other

    def __rmul__(self, other):
        return other * self.materialize()

    def __neg__(self):
        return -self.materialize()

    def __repr__(self):
        state = "pending" if self._fetcher._host is None else "materialized"
        return f"LazyDeviceArray({state}, index={self._index})"
