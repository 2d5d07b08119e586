"""Observability helpers of the port (mirrors arrow_go_tpu.utils):
the spans and counters of utils/metrics.py and a profiler trace, and
the device-memory leak watcher. The debug assertions are
`utils.debug`."""
from .memwatch import DeviceMemoryWatcher, device_live_bytes  # noqa: F401
from .metrics import Metrics, metrics, trace  # noqa: F401
