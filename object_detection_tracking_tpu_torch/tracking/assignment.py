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


def lapjv_extended(cost: np.ndarray, cost_limit: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """lap.lapjv(extend_cost=True, cost_limit=...) semantics used by TMOT
    (tmot/matching.py:26-37): rectangular cost with a per-assignment cost
    cap; unassigned entries get -1.

    Returns (x [n], y [m]): x[i] = matched column or -1, y[j] = matched row
    or -1.
    """
    cost = np.asarray(cost, np.float64)
    n, m = cost.shape
    if n == 0 or m == 0:
        return np.full(n, -1, np.int64), np.full(m, -1, np.int64)
    # inf entries (e.g. fuse_motion gating) would poison the solver's
    # arithmetic; anything >= cost_limit is equally unmatchable
    cost = np.where(np.isfinite(cost), cost, cost_limit * 2.0)
    # square extension trick (lap.lapjv extend_cost semantics): padding
    # rows/cols cost cost_limit/2 and the pad-pad quadrant is 0, so a real
    # assignment (i, j) survives iff cost[i, j] < cost_limit
    size = n + m
    big = np.full((size, size), cost_limit / 2.0, np.float64)
    big[n:, m:] = 0.0
    big[:n, :m] = cost
    rows, cols = linear_sum_assignment(big)
    x = np.full(n, -1, np.int64)
    y = np.full(m, -1, np.int64)
    for r, c in zip(rows, cols):
        if r < n and c < m:
            x[r] = c
            y[c] = r
    return x, y
