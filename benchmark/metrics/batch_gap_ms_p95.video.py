"""The 95th percentile of the gaps between consecutive outputs of the
runner, in ms, over the window's batches outside the profiled stretch
(nearest rank). None with fewer than 20 gaps."""

import math

from benchmark.metrics_common import host_batches


def read(obs):
    rows = host_batches(obs, consecutive=True)
    gaps = sorted(b["t_out"] - a["t_out"] for a, b in rows)
    if len(gaps) < 20:
        return None
    return 1e3 * gaps[math.ceil(0.95 * len(gaps)) - 1]
