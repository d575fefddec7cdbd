"""Share of the traced stretch in which no device operation ran, %. The
profiler starts a few outputs before the stretch, so every operation
running inside it is in the trace."""

from benchmark.harness import trace


def read(obs):
    rec = obs.get("trace")
    if not rec or not rec["device"]:
        return None
    lo, hi = rec["window"]
    return 100.0 * (1.0 - trace.busy_s(rec) / (hi - lo))
