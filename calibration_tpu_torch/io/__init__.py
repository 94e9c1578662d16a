from . import jsonio, stream_capture, validate
from .jsonio import dumps, from_jsonable, loads, to_jsonable
from .stream_capture import StreamCapture, WarningCollector
from .validate import validate_dataset

__all__ = [
    "jsonio", "stream_capture",
    "to_jsonable", "from_jsonable", "dumps", "loads",
    "StreamCapture", "WarningCollector", "validate", "validate_dataset",
]
