"""Host ms a batch between ``FasterRCNNFPN.forward``'s pre- and post-hooks:
the forward's issue of its device work.

Reads the run's host records (``obs["batches"]``, one a batch that the
runner returned in the window), leaving out the batches of the profiled
stretch. Returns None where no such batch exists."""

from benchmark.metrics_common import host_batches


def read(obs):
    rows = host_batches(obs)
    if not rows:
        return None
    return 1e3 * sum(r["forward_s"] for r in rows) / len(rows)
