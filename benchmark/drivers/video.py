"""The video driver: detect-and-track through the CLI's ``process_video``.

Set-up builds the CLI's configuration from its own ``get_args`` flags (the
configuration file's ``cli`` and the cell's), the detector on the card
with the seeded tree, the ``DetectionRunner`` as the CLI builds it, the
frame ring, and runs one warm-up clip of ``WARMUP_BATCHES`` batches at the
cell's own shapes. The window then calls ``process_video`` on clips of the
traffic's length, one after another, the reader ending the last at the
deadline; the window closes when that call returns, so the drain, the
interpolation and the MOT writes are inside it. ``video_fps`` is the
frames ``process_video`` returned over the window's wall time.

Host spans come from the benchmark's wrappers (``BenchRunner``): the
iterator that ``runner.run`` consumes, ``runner.run``'s ``next()``, forward
pre- and post-hooks on the model, and the caller's time between outputs.
With ``trace``, the profiler starts ``TRACE_LEAD`` outputs before the
traced stretch, so that every device operation running inside it was
launched under the profiler, and stops right after it; the stretch
(``bench.traced``) spans ``TRACE_BATCHES`` outputs after ``TRACE_SKIP``,
with no device sync at either end. Inside it, the arguments of every call
of the public ops ``odt::multilevel_roi_align`` (B1) and
``odt::greedy_keep`` (N1) are kept (``trace.OpCapture``: a Python kernel
in front of each op's own, nothing else slowed) for their rooflines.

After the window the program is freed and the sampled frames' outputs are
held against the float32 reference (``harness/check.py``).
"""

from __future__ import annotations

import gc
import os
import random
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import check, trace as tr, work
from benchmark.metrics_common import NMS_KERNEL, ROI_KERNEL, kernel_rows
from benchmark.harness.traffic import RingClip, render_ring, ring_frame
from benchmark.harness.weights import load_into, seeded_tree
from benchmark.reference.detector import ReferenceDetector, fp8_e4m3

WARMUP_BATCHES = 3      # the warm-up clip, at the cell's shapes
SAMPLE_BATCHES = 8      # batches of the window sampled for the reference
IMAGES_PER_BATCH = 2    # frames of each sampled batch
TRACE_SKIP = 6          # outputs of the window before the traced stretch
TRACE_BATCHES = 12      # outputs in the traced stretch
TRACE_LEAD = 3          # outputs profiled before it (the runner's depth+1)
ROI_OP, NMS_OP = "odt::multilevel_roi_align", "odt::greedy_keep"
# what the traced stretch keeps of each call of B1's and N1's public ops:
# the tensors the bounds read (no copies), the features' shapes alone
KEEP = {ROI_OP: lambda features, boxes, strides, pool, valid, levels: (
            [tuple(f.shape) for f in features], features[0].element_size(),
            boxes, valid, list(strides), int(pool), levels is None),
        NMS_OP: lambda boxes, valid, thres: (boxes, valid, float(thres))}


def _config_matches(cfg, conf: dict):
    """Raise unless the CLI's configuration is the file's."""
    m = conf["model"]
    got = {
        "resnet_blocks": list(cfg.resnet_num_block),
        "dilated_c5": cfg.use_dilations,
        "fpn_channels": cfg.fpn_num_channel,
        "fpn_multiple": cfg.fpn_resolution_requirement,
        "max_size": cfg.max_size,
        "anchor_strides": list(cfg.anchor_strides),
        "anchor_sizes": list(cfg.anchor_sizes),
        "anchor_ratios": list(cfg.anchor_ratios),
        "rpn_min_size": cfg.rpn_min_size,
        "rpn_nms_thres": cfg.rpn_proposal_nms_thres,
        "rpn_post_nms_topk": cfg.rpn_test_post_nms_topk,
        "num_class": cfg.num_class,
        "class_agnostic": cfg.use_frcnn_class_agnostic,
        "fc_dim": cfg.fpn_frcnn_fc_head_dim,
        "reg_weights": list(cfg.fastrcnn_bbox_reg_weights),
        "nms_thres": cfg.fastrcnn_nms_iou_thres,
        "score_thres": cfg.result_score_thres,
        "result_per_im": cfg.result_per_im,
        "mask": cfg.add_mask,
        "mask_dim": cfg.mrcnn_head_dim,
    }
    bad = {k: (v, m[k]) for k, v in got.items() if v != m[k]}
    for k, v in conf["detector"].items():
        if getattr(cfg, k) != v:
            bad[k] = (getattr(cfg, k), v)
    flags = (cfg.use_se, cfg.use_resnext, cfg.use_gn, cfg.use_deformable,
             cfg.use_conv_frcnn_head, cfg.use_att_frcnn_head,
             cfg.add_relation_nn, cfg.use_small_object_head)
    if bad or any(flags):
        raise ValueError(f"the CLI's configuration is not the file's: "
                         f"{bad or flags}")


class BenchRunner:
    """``DetectionRunner`` as ``process_video`` sees it, with the
    benchmark's spans and counts around it: per output batch a host record
    (output time, seconds in ``runner.run``'s ``next()``, of that in the
    enqueuer wait and the forward's issue, the caller's seconds after it,
    frames, tracked detections), output contract checks, a seeded sample
    of frames kept for the reference, and the profiled stretch."""

    def __init__(self, runner, model, conf: dict, args, batch: int,
                 seed: int, trace: bool = False, device: str = "cuda"):
        self.inner = runner
        self.batch = batch
        m = conf["model"]
        self.r = m["result_per_im"]
        self.n_labels = len(m["partial_label_idx"] or []) or m["num_class"]
        self.masks = m["mask"]
        self.tracked = [i for ids in conf["tracked_labels"].values()
                        for i in ids]
        self.min_conf = args.min_confidence
        self.rng = random.Random(int(seed))
        self.kept: List[tuple] = []       # (batch number, [(idx, outs)])
        self.records: List[dict] = []
        self.failures: List[str] = []
        self.recording = False
        self.n_out = 0
        self.trace = trace
        self.device = device
        self.prof = self.capture = None
        self.calls = None
        self.traced_host_s = 0.0
        self._acc = {"enqueue": 0.0, "forward": 0.0}
        self._fwd_t0 = None
        self._fwd_span = tr.Span("forward")
        model.register_forward_pre_hook(self._pre)
        model.register_forward_hook(self._post)

    # -- forward hooks
    def _pre(self, module, args):
        self._fwd_span.open()
        self._fwd_t0 = time.perf_counter()

    def _post(self, module, args, out):
        self._acc["forward"] += time.perf_counter() - self._fwd_t0
        self._fwd_span.close()

    # -- the iterator runner.run consumes
    def _timed(self, batches):
        it = iter(batches)
        while True:
            span = tr.Span("enqueue_wait").open()
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                self._acc["enqueue"] += time.perf_counter() - t0
                span.close()
            yield item

    def run(self, batches):
        it = self.inner.run(self._timed(batches))
        while True:
            self._acc = {"enqueue": 0.0, "forward": 0.0}
            span = tr.Span("runner").open()
            t0 = time.perf_counter()
            try:
                host, meta = next(it)
            except StopIteration:
                span.close()
                return
            t1 = time.perf_counter()
            span.close()
            traced = self.prof is not None
            rec = {"t_out": t1, "runner_s": t1 - t0,
                   "enqueue_s": self._acc["enqueue"],
                   "forward_s": self._acc["forward"], "traced": traced}
            real = np.asarray(meta[1]) >= 0
            rec["frames"] = int(real.sum())
            self._check(host)
            v = host["final_valid"][real]
            sel = v & np.isin(host["final_labels"][real], self.tracked) \
                & (host["final_probs"][real] >= self.min_conf)
            rec["tracked_dets"] = int(sel.sum())
            if self.recording:
                self._sample(host, meta, real)
            span = tr.Span("caller").open()
            yield host, meta
            span.close()
            rec["caller_s"] = time.perf_counter() - t1
            if self.recording:
                self.records.append(rec)
                self.n_out += 1
                self._trace_step()

    def _check(self, host):
        b, r = self.batch, self.r
        want = {"final_boxes": ((b, r, 4), np.float32),
                "final_labels": ((b, r), np.int32),
                "final_probs": ((b, r), np.float32),
                "final_valid": ((b, r), np.bool_),
                "pooled_box_feat": ((b, r, 256), np.float32)}
        if self.masks:
            want["final_masks"] = ((b, r, 28, 28), np.float32)
        if set(host) != set(want):
            self.failures.append(f"outputs {sorted(host)}")
            return
        for k, (shape, dt) in want.items():
            x = host[k]
            if x.shape != shape or x.dtype != dt:
                self.failures.append(f"{k} {x.shape} {x.dtype}")
            elif dt == np.float32 and not np.isfinite(x).all():
                self.failures.append(f"{k} not finite")
        lab = host["final_labels"]
        if ((lab < 0) | (lab >= self.n_labels)).any():
            self.failures.append("labels out of range")

    def _sample(self, host, meta, real):
        """Reservoir sample of ``SAMPLE_BATCHES`` batches (seeded), with
        ``IMAGES_PER_BATCH`` of each one's real frames."""
        i = self.n_out
        idx = np.flatnonzero(real)
        pick = sorted(self.rng.sample(list(idx), min(len(idx),
                                                     IMAGES_PER_BATCH)))
        item = (i, [(int(meta[1][j]),
                     {k: np.array(v[j]) for k, v in host.items()})
                    for j in pick])
        if len(self.kept) < SAMPLE_BATCHES:
            self.kept.append(item)
        else:
            j = self.rng.randint(0, i)
            if j < SAMPLE_BATCHES:
                self.kept[j] = item

    # -- the profiled stretch
    def _trace_step(self):
        if not self.trace:
            return
        if self.n_out == TRACE_SKIP - TRACE_LEAD and self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._t_trace = time.perf_counter()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        elif self.n_out == TRACE_SKIP and self.prof is not None:
            self._traced_span = tr.Span("traced").open()
            self.capture = tr.OpCapture(KEEP, self.device).__enter__()
        elif self.n_out == TRACE_SKIP + TRACE_BATCHES:
            self.stop_trace()

    def stop_trace(self):
        """Close the stretch and stop the profiler (whose exit waits for
        the device, after the stretch)."""
        if self.capture is not None:
            self.capture.__exit__(None, None, None)
            self.calls, self.capture = self.capture.calls, None
            self._traced_span.close()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.trace_done, self.prof = self.prof, None
            self.traced_host_s = time.perf_counter() - self._t_trace


def _launch_bounds(calls, record) -> Dict[str, float]:
    """The least seconds of the B1 and N1 launches of the traced stretch
    (``harness/work.py``), from the arguments of their public ops' calls,
    as ``roi_bound_s`` and ``nms_bound_s``. Where the calls that launch a
    kernel and the kernels that the trace holds from the stretch differ in
    number (a replayed graph that passes no call through the op, a
    renamed kernel), that bound is left out, so that its roofline is not
    reported, and the run says so on standard error: the roofline would
    pair a bound with the wrong time."""
    roi = []
    for shapes, elem, boxes, valid, strides, pool, canonical in \
            calls[ROI_OP]:
        if not canonical:
            raise ValueError("B1 launched with explicit levels")
        if boxes.shape[0] * boxes.shape[1] == 0:
            continue                            # no kernel launched
        v = valid if valid is not None else torch.ones(
            boxes.shape[:2], dtype=torch.bool, device=boxes.device)
        roi.append(work.roi_bound_s(shapes, elem, boxes, v, strides, pool))
    nms = [work.nms_bound_s(b, v, t) for b, v, t in calls[NMS_OP]
           if v.numel()]
    out = {}
    for name, key, bounds, part in (("B1", "roi_bound_s", roi, ROI_KERNEL),
                                    ("N1", "nms_bound_s", nms, NMS_KERNEL)):
        n = len(kernel_rows(record, part))
        if n == len(bounds):
            out[key] = sum(bounds)
        else:
            print(f"trace: {name}: {len(bounds)} launches through its op "
                  f"in the traced stretch, {n} of its kernels in the trace;"
                  f" its roofline is left out", file=sys.stderr)
    return out


def run(files: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", fault: Optional[Callable] = None,
        control: bool = False) -> dict:
    """One run of a video cell (module note). ``fault`` (tests only)
    wraps the model's forward to break the timed path; ``control`` (the
    control study only) also reads the float8 reference in the program's
    place on the same frames (``control_readings``)."""
    from object_detection_tracking_tpu_torch.cli import \
        obj_detect_tracking as cli
    from object_detection_tracking_tpu_torch.class_ids import \
        coco_obj_to_actev_obj
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.runtime import DetectionRunner

    cellf, conf, traffic = files["cell"], files["config"], files["traffic"]
    stamps = [("imports", time.perf_counter())]
    out_dir = tempfile.mkdtemp(prefix="bench_video_")
    try:
        args = cli.get_args(
            ["--video_dir", out_dir, "--video_lst_file",
             os.path.join(out_dir, "none"), "--tracking_dir",
             os.path.join(out_dir, "tracks"), "--device", device]
            + conf["cli"] + cellf["cli"])
        dev = torch.device(device)
        cfg = cli.build_config(args, dev)
        _config_matches(cfg, conf)
        with dev:
            model = get_model(cfg, "faster_rcnn")
        shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        tree = seeded_tree(shapes, seed, dev, conf["weights"])
        load_into(model, tree).eval()
        stamps.append(("model_weights", time.perf_counter()))
        if fault is not None:
            fault(model)
        runner = DetectionRunner(model, emb_agg=args.emb_agg_method,
                                 ship_full_feat=args.get_box_feat)
        gap, b = args.frame_gap, args.im_batch_size
        ring = render_ring(traffic, seed, gap)
        stamps.append(("ring", time.perf_counter()))
        coco = (dict(coco_obj_to_actev_obj)
                if args.is_coco_model or args.use_partial_classes else None)
        bench = BenchRunner(runner, model, conf, args, b, seed, trace,
                            dev.type)

        def clip(name, frames, deadline=None):
            vcap = RingClip(ring, gap, frames, traffic["fps"], deadline)
            n = cli.process_video(args, cfg, bench, name + ".mp4",
                                  cfg.classid2name, coco, vcap=vcap)
            return n, -(-vcap.i // gap)

        clip("warmup", WARMUP_BATCHES * b * gap)
        stamps.append(("warmup_clip", time.perf_counter()))
        peak_setup = 0
        if dev.type == "cuda":
            torch.cuda.synchronize()
            peak_setup = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        clip_frames = int(traffic["clip_seconds"] * traffic["fps"])
        bench.recording = True
        t0 = time.perf_counter()
        deadline = t0 + seconds
        done = read = clips = 0
        while time.perf_counter() < deadline:
            n, r = clip(f"clip{clips:03d}", clip_frames, deadline)
            done, read, clips = done + n, read + r, clips + 1
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        window_s = t1 - t0
        bench.stop_trace()      # where the window ended inside the stretch
        peak_window = (torch.cuda.max_memory_allocated()
                       if dev.type == "cuda" else 0)
        peak_process = max(peak_setup, peak_window)
        flops = work.forward_flops(dict(shapes), conf["model"], 1,
                                   ring[0].shape[0], ring[0].shape[1],
                                   conf["model"]["rpn_post_nms_topk"])
        captured = None
        obs = {"batches": bench.records, "window_s": window_s,
               "frames": done, "flops_per_frame": flops["total"],
               "peak_bytes_window": peak_window,
               "traced_host_s": bench.traced_host_s}
        prof = getattr(bench, "trace_done", None)
        # free the program before the reference runs
        del runner, model
        bench.inner = None
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if trace:
            obs["trace"] = tr.device_record(prof) if prof else None
            captured = {k: len(v) for k, v in (bench.calls or {}).items()}
            if bench.calls is not None and dev.type == "cuda":
                obs.update(_launch_bounds(bench.calls, obs["trace"]))
            bench.calls = None
        frames, outs = [], []
        for _, items in sorted(bench.kept):
            for idx, o in items:
                frames.append(ring_frame(ring, gap, idx))
                outs.append(o)
        t_check = time.perf_counter()
        reference = ReferenceDetector(tree, conf["model"])
        values = check.readings(reference, frames, outs) if outs else {}
        check_s = time.perf_counter() - t_check
        ok, table = check.judge(values, cellf["limits"])
        control_values = None
        if control and outs:
            low = ReferenceDetector(tree, conf["model"], quant=fp8_e4m3)
            control_values = check.readings(
                reference, frames, check.control_outputs(low, frames))
        lost = read - done
        failed = lost + (b if bench.failures else 0)
        correct = ok and not bench.failures and lost == 0 and bool(outs)
        return {
            "correct": correct, "attempted": read, "failed": failed,
            "failures": bench.failures[:5], "checks": table,
            "video_fps": done / window_s,
            "setup_s": t0 - t_start, "obs": obs, "clips": clips,
            "memory_peak_bytes": peak_process, "flops": flops,
            "compared": len(outs), "readings": values, "check_s": check_s,
            "setup_parts": {name: round(t - prev, 3) for (name, t), (_, prev)
                            in zip(stamps, [("start", t_start)] + stamps)},
            "tracked_dets_per_frame": (
                sum(r["tracked_dets"] for r in obs["batches"])
                / max(1, sum(r["frames"] for r in obs["batches"]))),
            "control_readings": control_values, "captured": captured,
        }
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
