"""Device ms a batch of the operations that ``FasterRCNNFPN.forward``
launched (under its ``bench.forward`` span) inside the traced stretch."""

from benchmark.metrics_common import launched_in_stretch


def read(obs):
    rec = obs.get("trace")
    if not rec or not rec["device"]:
        return None
    lo, hi = rec["window"]
    n = sum(1 for name, s, e in rec["spans"]
            if name == "bench.forward" and s >= lo and e <= hi)
    if not n:
        return None
    t = sum(d[2] - d[1] for d in launched_in_stretch(rec)
            if d[4] == "bench.forward")
    return 1e3 * t / n
