"""Host ms a batch in ``process_video`` between an output and its next
request to the runner: Deep SORT and the MOT bookkeeping.

Reads the run's host records (``obs["batches"]``, one a batch that the
runner returned in the window), leaving out the batches of the profiled
stretch. Returns None where no such batch exists."""

from benchmark.metrics_common import host_batches


def read(obs):
    rows = host_batches(obs)
    if not rows:
        return None
    return 1e3 * sum(r["caller_s"] for r in rows) / len(rows)
