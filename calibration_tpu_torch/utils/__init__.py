from . import lazy
from .lazy import BatchFetcher, LazyDeviceArray

__all__ = ["lazy", "BatchFetcher", "LazyDeviceArray"]
