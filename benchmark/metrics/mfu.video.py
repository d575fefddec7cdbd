"""The whole step's share of the card's bf16 peak, in %: the model FLOPs
of the frames the runner returned outside the profiled part (the
reference's conv, deconv and linear layers at the cell's shapes, counted
on the meta device) over the host seconds of that part of the window,
against 989 TFLOP/s."""

from benchmark.harness.work import PEAK_BF16_FLOPS


def read(obs):
    frames = sum(r["frames"] for r in obs["batches"] if not r["traced"])
    seconds = obs["window_s"] - obs.get("traced_host_s", 0.0)
    if not frames or seconds <= 0:
        return None
    return 100.0 * obs["flops_per_frame"] * frames / seconds \
        / PEAK_BF16_FLOPS
