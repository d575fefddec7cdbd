"""Each per-layer reader gives its number on a small synthetic run."""

import math

import pytest
import torch

from benchmark.harness import spec, trace

BENCH = spec.benchmark()


def synthetic_obs():
    """24 host batches (the fourth profiled) and a 1-second traced
    stretch: two forwards, each with a 0.2 s conv and a 0.05 s B1 launch,
    one 0.1 s N1 launch, a 0.05 s copy outside the forward; and a B1
    launch before the stretch, which no reader counts."""
    rows = []
    for i in range(24):
        rows.append({"t_out": 0.1 * i + (0.05 if i == 12 else 0.0),
                     "runner_s": 0.06, "enqueue_s": 0.01,
                     "forward_s": 0.02, "caller_s": 0.03, "frames": 8,
                     "tracked_dets": 40, "traced": i == 3})
    device = [    # (name, start, end, op, span, launch)
        ("roi_align_fwd_kernel", -0.1, -0.05, "odt::multilevel_roi_align",
         "bench.forward", -0.15),       # launched before the stretch
        ("conv_kernel", 0.0, 0.2, "aten::conv2d", "bench.forward", 0.0),
        ("roi_align_fwd_kernel", 0.2, 0.25, "odt::multilevel_roi_align",
         "bench.forward", 0.01),
        ("nms_keep_kernel", 0.25, 0.35, "odt::greedy_keep", "bench.forward",
         0.02),
        ("conv_kernel", 0.5, 0.7, "aten::conv2d", "bench.forward", 0.5),
        ("roi_align_fwd_kernel", 0.7, 0.75, "odt::multilevel_roi_align",
         "bench.forward", 0.55),
        ("Memcpy DtoH", 0.8, 0.85, "aten::copy_", "bench.runner", 0.8),
    ]
    spans = [("bench.traced", 0.0, 1.0), ("bench.forward", 0.0, 0.1),
             ("bench.forward", 0.5, 0.6), ("bench.runner", 0.0, 0.9),
             ("bench.caller", 0.9, 1.0)]
    return {"batches": rows, "window_s": 2.5, "frames": 192,
            "flops_per_frame": 1e12, "peak_bytes_window": 3 * 2 ** 30,
            "traced_host_s": 0.1, "roi_bound_s": 0.05, "nms_bound_s": 0.01,
            "trace": {"window": (0.0, 1.0), "device": device,
                      "spans": spans}}


EXPECTED = {
    "enqueue_wait_ms.video": 10.0,
    "runner_other_ms.video": 30.0,
    "forward_issue_ms.video": 20.0,
    "caller_ms.video": 30.0,
    "peak_mem_gib.video": 3.0,
    "forward_device_ms.video": 1e3 * 0.6 / 2,
    "device_idle_pct.video": 100.0 * (1 - 0.65),
    "roi_align_roofline.video": 100.0 * 0.05 / 0.1,
    "nms_roofline.video": 100.0 * 0.01 / 0.1,
    "mfu.video": 100.0 * 1e12 * 23 * 8 / 2.4 / 989e12,
    "batch_gap_ms_p95.video": 100.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    got = spec.reader(name)(synthetic_obs())
    assert math.isclose(got, EXPECTED[name], rel_tol=1e-9), (name, got)


def test_every_metric_has_a_case():
    assert {m["name"] for m in BENCH["per_layer"]} == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_without_a_trace(name):
    """A reader that finds nothing to read returns None, never 0 for a
    share of a roofline or a peak."""
    obs = dict(synthetic_obs(), trace=None, roi_bound_s=0.0,
               nms_bound_s=0.0, peak_bytes_window=0)
    got = spec.reader(name)(obs)
    if "roofline" in name or "mfu" in name or name.startswith("device_"):
        assert got is None or got > 0


def test_breakdown_groups_by_op_and_span():
    rec = synthetic_obs()["trace"]
    br = trace.breakdown(rec)
    ops = dict(br["device_ops"])
    assert math.isclose(ops["aten::conv2d"], 0.4)
    assert math.isclose(ops["odt::multilevel_roi_align"], 0.1)
    gaps = dict(br["idle_gaps"])
    # idle: 0.35-0.5 and 0.75-0.8 in the runner, 0.85-1.0 (its middle in
    # the caller)
    assert math.isclose(gaps["runner"], 0.2)
    assert math.isclose(gaps["caller"], 0.15)
    assert math.isclose(trace.busy_s(rec), 0.65)


def test_op_capture_keeps_the_public_ops_arguments():
    """The capture sees N1's public op with its own arguments (no copy)
    and lets every other operator through."""
    from object_detection_tracking_tpu_torch.ops import nms as N
    boxes = torch.rand(2, 10, 4)
    boxes[..., 2:] += boxes[..., :2]
    scores = torch.rand(2, 10)
    want = N.nms(boxes, scores, 5, 0.5)
    keep = spec.driver("video").KEEP
    with trace.OpCapture(keep, "cpu") as cap:
        got = N.nms(boxes, scores, 5, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    (b, v, t), = cap.calls["odt::greedy_keep"]
    assert b.shape == (2, 10, 4) and v.shape == (2, 10) and t == 0.5
    assert cap.calls["odt::multilevel_roi_align"] == []
    N.nms(boxes, scores, 5, 0.5)            # the capture is gone
    assert len(cap.calls["odt::greedy_keep"]) == 1


def test_launch_bounds_leave_out_a_count_that_differs(capsys):
    """A launch through the op without its kernel in the stretch (or the
    other way round) leaves that bound out, and says so, rather than
    pairing the wrong time."""
    drv = spec.driver("video")
    boxes = torch.tensor([[[0.0, 0.0, 4.0, 4.0], [1.0, 1.0, 5.0, 5.0]]])
    valid = torch.ones(1, 2, dtype=torch.bool)
    calls = {drv.ROI_OP: [], drv.NMS_OP: [(boxes, valid, 0.5)]}
    rec = synthetic_obs()["trace"]
    rec["device"] = [d for d in rec["device"] if "nms" in d[0]]
    got = drv._launch_bounds(calls, rec)        # one N1 kernel, one call
    assert got["roi_bound_s"] == 0.0 and got["nms_bound_s"] > 0
    assert capsys.readouterr().err == ""
    got = drv._launch_bounds({drv.ROI_OP: [], drv.NMS_OP: []}, rec)
    assert got == {"roi_bound_s": 0.0}
    assert "N1: 0 launches through its op" in capsys.readouterr().err


def test_traced_run_on_cpu():
    """A tiny traced run through the video driver: the traced stretch
    and the profiled lead before it are left out of the host metrics."""
    import time
    from benchmark.tests.tiny import DRIVER_CONSTANTS, tiny_driver, \
        tiny_files
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = tiny_driver().run(tiny_files("meva_video_720p"), 2 ** 31 + 21,
                                1.5, True, time.perf_counter(),
                                device="cpu")
    finally:
        torch.set_num_threads(n)
    obs = res["obs"]
    lo, hi = obs["trace"]["window"]
    assert 0 < lo < hi
    assert [s for s in obs["trace"]["spans"] if s[0] == "bench.forward"]
    traced = sum(r["traced"] for r in obs["batches"])
    assert traced == DRIVER_CONSTANTS["TRACE_LEAD"] \
        + DRIVER_CONSTANTS["TRACE_BATCHES"]
    assert obs["traced_host_s"] > 0
    assert spec.reader("forward_issue_ms.video")(obs) > 0
    # N1 twice a forward (the RPN's and the per-class NMS); how many
    # forwards the stretch issues depends on where the tiny clips end
    got = res["captured"]
    assert got["odt::greedy_keep"] > 0 and got["odt::greedy_keep"] % 2 == 0
    assert got["odt::multilevel_roi_align"] > 0
