"""Host ms a batch inside ``DetectionRunner.run``'s ``next()``, less the
enqueue wait and the forward's issue: the pin, the upload and the wait
for the device-to-host copy.

Reads the run's host records (``obs["batches"]``, one a batch that the
runner returned in the window), leaving out the batches of the profiled
stretch. Returns None where no such batch exists."""

from benchmark.metrics_common import host_batches


def read(obs):
    rows = host_batches(obs)
    if not rows:
        return None
    return 1e3 * sum(r["runner_s"] - r["enqueue_s"] - r["forward_s"]
               for r in rows) / len(rows)
