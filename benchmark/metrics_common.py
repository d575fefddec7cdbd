"""What the per-layer metric readers share: the host records outside the
profiled part of the window, and the device operations launched inside
the traced stretch."""

# what the names of kernels B1 (csrc/roi_align.cu) and N1 (csrc/nms.cu) hold
ROI_KERNEL = "roi_align_fwd"
NMS_KERNEL = "nms_keep"


def host_batches(obs, consecutive=False):
    """The window's host records outside the profiled part; with
    ``consecutive``, the pairs of successive outputs both outside it."""
    rows = obs["batches"]
    if not consecutive:
        return [r for r in rows if not r["traced"]]
    return [(a, b) for a, b in zip(rows, rows[1:])
            if not a["traced"] and not b["traced"]]


def launched_in_stretch(record):
    """The device rows of ``record`` whose launch lies in its traced
    stretch."""
    lo, hi = record["window"]
    return [d for d in record["device"] if lo <= d[5] <= hi]


def kernel_rows(record, part: str):
    """The rows of the kernels whose name holds ``part``, launched inside
    the traced stretch."""
    if not record:
        return []
    return [d for d in launched_in_stretch(record) if part in d[0]]


def kernel_s(obs, part: str) -> float:
    """Device seconds of the kernels whose name holds ``part``, launched
    inside the traced stretch, each whole (the profiler records every
    launch to its end)."""
    return sum(e - s for _, s, e, _, _, _ in
               kernel_rows(obs.get("trace"), part))
