from . import lazy, profiling
from .lazy import BatchFetcher, LazyDeviceArray
from .profiling import Timer, device_trace, lm_cost_trace

__all__ = ["lazy", "profiling", "BatchFetcher", "LazyDeviceArray", "Timer", "device_trace", "lm_cost_trace"]
