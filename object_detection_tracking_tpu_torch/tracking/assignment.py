"""Linear assignment: native C++ lapjv fast path with scipy fallback.

Port of object_detection_tracking_tpu/tracking/assignment.py. The solver
is the port's ``csrc/lapjv.cpp``, built with g++ into the package's
git-ignored ``build/`` directory on first use. Both paths return an optimal
assignment (cost ties may differ — both are optimal).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import scipy.optimize

from ..native import PKG_DIR, build_shared

_SRC = os.path.join(PKG_DIR, "csrc", "lapjv.cpp")
_lib = None
_tried = False


def _load_native() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SRC):
        return None
    try:
        path = build_shared(_SRC, ["g++", "-O3", "-shared", "-fPIC"],
                            "lapjv")
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None   # no C++ compiler: scipy serves every call
    lib = ctypes.CDLL(path)
    lib.lapjv_dense.restype = ctypes.c_double
    lib.lapjv_dense.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib
    return _lib


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal assignment over a rectangular cost matrix; returns (rows,
    cols) like scipy. Uses native lapjv for square matrices above a small
    size; scipy otherwise."""
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    lib = _load_native()
    if lib is not None and n == m and n >= 8:
        c = np.ascontiguousarray(cost)
        x = np.empty(n, np.int32)
        y = np.empty(n, np.int32)
        lib.lapjv_dense(
            n,
            c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        rows = np.arange(n, dtype=np.int64)
        return rows, x.astype(np.int64)
    return scipy.optimize.linear_sum_assignment(cost)
