"""Runtime of the port: the pipelined detector runner and host
observability."""

from .runner import DetectionRunner  # noqa: F401
from .profiler import PerformanceLogger  # noqa: F401
