"""Host observability: a background utilization sampler and op-level traces
(port of object_detection_tracking_tpu/runtime/profiler.py:25-89).

Reference PerformanceLogger (utils.py:252-293) polls nvidia-smi and psutil;
this one samples host CPU and RSS with psutil and the device memory the
caching allocator holds for tensors (``torch.cuda.memory_allocated``) on a
thread, in the JAX logger's series: ``time``, ``cpu_percent``, ``rss_mb``,
``device_bytes``. ``device_bytes`` is 0.0 for a CPU device, as the JAX
logger gives 0 for a device without memory statistics.
``start_trace``/``stop_trace`` wrap ``torch.profiler`` and write a Chrome
trace under ``log_dir``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None


class PerformanceLogger:
    def __init__(self, interval: float = 10.0, device=None):
        self.interval = interval
        self.device = torch.device(device) if device is not None else None
        self.series: Dict[str, List[float]] = {
            "time": [], "cpu_percent": [], "rss_mb": [], "device_bytes": []}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _sample(self):
        self.series["time"].append(time.time())
        if psutil is not None:
            p = psutil.Process()
            self.series["cpu_percent"].append(psutil.cpu_percent())
            self.series["rss_mb"].append(p.memory_info().rss / 1e6)
        else:
            self.series["cpu_percent"].append(0.0)
            self.series["rss_mb"].append(0.0)
        dev_bytes = 0.0
        if self.device is not None and self.device.type == "cuda":
            dev_bytes = float(torch.cuda.memory_allocated(self.device))
        self.series["device_bytes"].append(dev_bytes)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self._sample()
            except Exception:
                pass

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def end(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def summary(self) -> Dict[str, float]:
        out = {}
        for k in ("cpu_percent", "rss_mb", "device_bytes"):
            vals = self.series[k]
            if vals:
                out[f"{k}_median"] = float(np.median(vals))
                out[f"{k}_max"] = float(np.max(vals))
        return out

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.series, f)


_TRACE: Dict[str, object] = {}


def start_trace(log_dir: str):
    """Start an op-level trace of the host and, where CUDA is available,
    the card; ``stop_trace`` writes it under ``log_dir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _TRACE.update(prof=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop the trace ``start_trace`` began and write it as
    ``<log_dir>/trace_<unix time>.json`` (Chrome trace format); returns
    the path."""
    prof, log_dir = _TRACE.pop("prof"), _TRACE.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace_%d.json" % int(time.time()))
    prof.export_chrome_trace(path)
    return path
