"""Host ms a batch that ``DetectionRunner.run`` waits on the next batch
from ``VideoEnqueuer`` (the iterator it consumes).

Reads the run's host records (``obs["batches"]``, one a batch that the
runner returned in the window), leaving out the batches of the profiled
stretch. Returns None where no such batch exists."""

from benchmark.metrics_common import host_batches


def read(obs):
    rows = host_batches(obs)
    if not rows:
        return None
    return 1e3 * sum(r["enqueue_s"] for r in rows) / len(rows)
