"""Runtime of the port: the pipelined detector runner, host observability,
and the packed forward (AOT export, CUDA-graph replay, kernel cache)."""

from .runner import DetectionRunner  # noqa: F401
from .profiler import PerformanceLogger  # noqa: F401
from .aot import enable_persistent_cache, aot_compile  # noqa: F401
