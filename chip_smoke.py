#!/usr/bin/env python3
"""Drive the PyTorch port's video detect-and-track path on one NVIDIA GPU
and hold every hand-written kernel against its plain PyTorch version.

Run from the root of the repository, on a machine with a CUDA GPU, nvcc
(/usr/local/cuda) and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the exit code is not 0:
  1. device    the card's name and power limit; TF32 off for the f32 checks
  2. build     every CUDA kernel under object_detection_tracking_tpu_torch/
               csrc, compiled by nvcc for sm_90a, timed; the bottleneck-
               stage library's SASS must hold HGMMA (wgmma) instructions
  3. kernels   ROIAlign kernel vs the plain version at the main path's
               shapes (B=8, the 736x1280 FPN pyramid, C=256, P=7, N=1000
               and N=100), f32 and bf16 features, ~30% invalid slots,
               zero-area, edge and aspect-5 boxes; median CUDA-event times
               of the wrapper's call, the kernel's own device time
               (torch.profiler) and its share of the bound
  4. main path R50-FPN partial-COCO at full width (random weights from seed
               0), bf16: synthetic 1280x720 frames -> VideoEnqueuer ->
               DetectionRunner -> Deep SORT on Person and Vehicle -> MOT
               files, through the CLI's process_video; the ROIAlign launch
               count must rise by exactly 2 per batch; then one batch in f32
               with the kernel and with the plain ROIAlign, compared; then
               both ROIAlign launches of a bf16 forward redone on its own
               inputs (proposals, final boxes) by kernel and plain version
  5. profile   device time by kernel over one more batch (torch.profiler)
  6. stage     bottleneck-stage kernel vs the plain version at the ActEV
               path's three stage shapes (B=8, 1088x1920: c2 3 blocks with
               the shortcut conv, c3 tail 3 blocks, c4 tail 22 blocks), f32
               (TF32 off) and bf16, non-trivial frozen-BN statistics; median
               CUDA-event times of kernel, plain version and the port's
               unfused cuDNN Bottleneck stack over the same blocks; the
               kernel's bf16 time split by conv kind (1x1, 3x3) within one
               stack (torch.profiler), beside the stack's bound and the
               per-conv floor
  7. actev     the CLI's default detector, R101-FPN v4 (dilated c5, class-
               agnostic box head, 16 ActEV classes) at 1920x1080 with the
               Mask R-CNN head, backbone_impl="pallas", bf16, B=8, frame gap
               8: synthetic frames -> VideoEnqueuer -> DetectionRunner ->
               Deep SORT on Person and Vehicle -> MOT files, through
               process_video; both kernels must launch exactly 3 times per
               batch; then one f32 batch with the fused and with the unfused
               backbone, compared; then every kernel launch of one bf16
               forward redone on its own inputs by kernel and plain
               version, each ROIAlign launch timed as in phase 3
  8. profile   that path: host wall of one forward with the fused and the
               unfused backbone, device time by kernel kind
Then one JSON line of kernels, the card line, and the last line:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script imports nothing of JAX: the port must run without it.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None   # any attempt to import JAX fails loudly

STRIDES = (4, 8, 16, 32)
PYRAMID = ((184, 320), (92, 160), (46, 80), (23, 40))   # 736x1280 padded
FRAME_H, FRAME_W, BATCH, FRAME_GAP, N_BATCHES = 720, 1280, 8, 8, 8
ACTEV_H, ACTEV_W = 1080, 1920            # padded to 1088x1920 by the model
# the ActEV path's fused stages at B=8: name, H, W, C_in, width, blocks
STAGES = (("c2", 272, 480, 64, 64, 3), ("c3", 136, 240, 512, 128, 3),
          ("c4", 68, 120, 1024, 256, 22))
# bottleneck stage, kernel vs plain, as a share of max |plain|: float32
# (TF32 off) sums the same products in another order; bf16 rounds each
# intermediate, and one rounding that lands the other way moves everything
# after it: the JAX package's own bf16 bound for its Pallas stage kernel,
# which it sets for stacks of up to 3 blocks. Such flips pile up block
# after block like a random walk, so for a deeper stack the bf16 bound
# grows with the square root of its depth in 3-block units (the c4 tail's
# 22 blocks: x2.7). phase_stage also shows the plain version itself moving
# by as much when only the order of its float32 sums changes.
STAGE_REL = {"float32": 1e-4, "bfloat16": 2e-2}

# f32 forward, fused vs unfused backbone: FPN maps within this share of
# their largest magnitude
FPN_REL = 1e-4
# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
PEAK_BF16_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# kernel vs plain: both sample the same float32 fpcoor points (the kernel
# rounds its coordinates exactly like the plain ops); only the order of
# the bilinear and 2x2 sums differs, ~1e-6 on unit-normal features
KERNEL_ATOL = 1e-4
# f32 forward, ROIAlign kernel vs plain: share of the plain run's
# detections matched by the kernel run (same label, box within 0.5 px).
# Sums ~1e-6 apart can swap two detections' ranks; only a swap across the
# top-100 cut-off changes the set, at most a detection or two per image.
MATCH_MIN = 0.98


def stage_rel(dtype_name, n_blocks):
    """The stage check's bound as a share of max |plain| (STAGE_REL)."""
    if dtype_name == "float32":
        return STAGE_REL["float32"]
    return STAGE_REL["bfloat16"] * math.sqrt(max(1.0, n_blocks / 3))


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(fns, reps=15, warmup=3):
    """Median CUDA-event time of each fn, calls interleaved in turns."""
    import torch
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for r in range(reps):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[i]()
            end.record()
            end.synchronize()
            times[i].append(start.elapsed_time(end))
    return [sorted(t)[len(t) // 2] for t in times]


def roi_case(gen, n, dtype):
    """Main-path ROIAlign inputs: features on the 736x1280 pyramid, n boxes
    per image with ~30% invalid slots and the edge cases."""
    import torch
    feats = [torch.randn(BATCH, h, w, 256, device="cuda", generator=gen)
             .to(dtype) for h, w in PYRAMID]
    xy = torch.rand(BATCH, n, 2, device="cuda", generator=gen) * \
        torch.tensor([FRAME_W, FRAME_H], device="cuda")
    wh = torch.exp(torch.rand(BATCH, n, 2, device="cuda", generator=gen)
                   * math.log(600.0))
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[:, 0] = torch.tensor([0.0, 0.0, 0.0, 0.0])                # zero-area
    boxes[:, 1] = torch.tensor([0.0, 0.0, FRAME_W, FRAME_H])       # whole frame
    boxes[:, 2] = torch.tensor([FRAME_W - 9.0, FRAME_H - 9.0, FRAME_W,
                                FRAME_H])                          # corner
    boxes[:, 3] = torch.tensor([100.0, 50.0, 100.0 + 48.3, 50.0 + 241.5])
    boxes[:, 4] = torch.tensor([300.0, 400.0, 300.0 + 241.5, 400.0 + 48.3])
    boxes[:, 5] = torch.tensor([50.0, 20.0, 50.0, 90.0])           # zero width
    lim = torch.tensor([FRAME_W, FRAME_H, FRAME_W, FRAME_H], device="cuda")
    boxes = torch.minimum(boxes, lim).contiguous()
    valid = torch.rand(BATCH, n, device="cuda", generator=gen) > 0.3
    valid[:, :6] = True
    return feats, boxes, valid


def phase_kernels():
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    for n in (1000, 100):
        for dtype in (torch.float32, torch.bfloat16):
            feats, boxes, valid = roi_case(gen, n, dtype)

            def kernel():
                return RA.multilevel_roi_align_cuda(feats, boxes, STRIDES, 7,
                                                    valid=valid)

            def plain():
                return RA.multilevel_roi_align(feats, boxes, STRIDES, 7,
                                               valid=valid)

            got = kernel()
            torch.cuda.synchronize()
            ref = plain()
            err = (got - ref).abs().max().item()
            if not err <= KERNEL_ATOL:
                raise AssertionError(
                    f"roi_align N={n} {dtype}: max |kernel - plain| {err} "
                    f"> {KERNEL_ATOL}")
            if got[~valid].abs().max().item() != 0.0:
                raise AssertionError("roi_align: invalid slots not zero")
            k_ms, p_ms = median_ms([kernel, plain])
            d_ms = roi_device_ms(kernel)
            b_ms = roi_bound_ms(feats, boxes, valid, STRIDES, 7)
            results[(n, dtype)] = (err, k_ms, p_ms, b_ms, d_ms)
            log("kernels", f"roi_align N={n} {str(dtype)[6:]}: max_abs_err "
                f"{err:.3g} (bound {KERNEL_ATOL}), kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms (median of 15, CUDA events), kernel "
                f"device {d_ms:.4f} ms (torch.profiler, mean of 15), bound "
                f"{b_ms:.4f} ms (bytes), {b_ms / d_ms:.1%} of it")
            del feats, boxes, valid, got, ref
    return results


class SyntheticVideo:
    """In-memory BGR video of moving rectangles (numpy), 1280x720 unless
    given another size, read through the port's VideoReader interface;
    grab() skips for free."""

    def __init__(self, n_frames, seed=0, h=FRAME_H, w=FRAME_W):
        import numpy as np
        self.num_frames = n_frames
        self.fps = 30.0
        self.i = 0
        self.h, self.w = h, w
        rng = np.random.RandomState(seed)
        ramp = np.linspace(40, 90, w).astype(np.uint8)
        self.base = np.ascontiguousarray(
            np.broadcast_to(ramp[None, :, None], (h, w, 3)))
        # 12 boxes of 40-128 x 80-240 px (at 1280x720), each moving at
        # a constant velocity and wrapping around the frame
        self.objs = [(rng.randint(0, w), rng.randint(0, h),
                      rng.randint(2, 6), rng.randint(-2, 3),
                      rng.randint(w // 32, w // 10),
                      rng.randint(h // 9, h // 3),
                      rng.randint(0, 256, 3).astype(np.uint8))
                     for _ in range(12)]

    def read(self):
        if self.i >= self.num_frames:
            return False, None
        frame = self.base.copy()
        for x0, y0, vx, vy, w, h, color in self.objs:
            x = int(x0 + vx * self.i) % (self.w - w)
            y = int(y0 + vy * self.i) % (self.h - h)
            frame[y:y + h, x:x + w] = color
        self.i += 1
        return True, frame

    def grab(self):
        if self.i >= self.num_frames:
            return False
        self.i += 1
        return True

    def release(self):
        pass


class CheckedRunner:
    """Wraps DetectionRunner.run: checks every host output against the
    output contract, counts batches, frames and valid detections, and
    splits the wall time between the runner and its caller."""

    def __init__(self, runner, r, n_labels=6, masks=False):
        self.runner, self.r = runner, r
        self.n_labels, self.masks = n_labels, masks
        self.batches = self.frames = self.dets = 0
        self.by_label = {}
        # wall split: inside runner.run (batch wait, H2D, forward, D2H) and
        # in the caller between batches
        self.runner_s = self.consumer_s = 0.0

    def run(self, batches):
        import numpy as np
        it = self.runner.run(batches)
        while True:
            t0 = time.perf_counter()
            try:
                host, meta = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter()
            self.runner_s += t1 - t0
            b, r = BATCH, self.r
            shapes = {"final_boxes": ((b, r, 4), np.float32),
                      "final_labels": ((b, r), np.int32),
                      "final_probs": ((b, r), np.float32),
                      "final_valid": ((b, r), np.bool_),
                      "pooled_box_feat": ((b, r, 256), np.float32)}
            if self.masks:
                shapes["final_masks"] = ((b, r, 28, 28), np.float32)
            if set(host) != set(shapes):
                raise AssertionError(f"outputs {sorted(host)}")
            for k, (shape, dt) in shapes.items():
                v = host[k]
                if v.shape != shape or v.dtype != dt:
                    raise AssertionError(f"{k}: {v.shape} {v.dtype}, "
                                         f"want {shape} {dt}")
                if dt == np.float32 and not np.isfinite(v).all():
                    raise AssertionError(f"{k} is not finite")
            if not ((host["final_labels"] >= 0)
                    & (host["final_labels"] < self.n_labels)).all():
                raise AssertionError(f"labels outside 0..{self.n_labels - 1}")
            if self.masks and not ((host["final_masks"] >= 0)
                                   & (host["final_masks"] <= 1)).all():
                raise AssertionError("final_masks outside [0, 1]")
            real = np.asarray(meta[1]) >= 0
            self.batches += 1
            self.frames += int(real.sum())
            valid = host["final_valid"][real]
            self.dets += int(valid.sum())
            for lab in host["final_labels"][real][valid]:
                self.by_label[int(lab)] = self.by_label.get(int(lab), 0) + 1
            yield host, meta
            # the caller's work on this batch: Deep SORT, MOT bookkeeping
            self.consumer_s += time.perf_counter() - t1


def match_share(ref, got):
    """Share of ref's valid detections that got has with the same label
    and a box within 0.5 px."""
    import numpy as np
    hit = total = 0
    for b in range(ref["final_valid"].shape[0]):
        rv = np.flatnonzero(ref["final_valid"][b])
        gv = np.flatnonzero(got["final_valid"][b])
        for i in rv:
            total += 1
            d = np.abs(got["final_boxes"][b, gv]
                       - ref["final_boxes"][b, i]).max(-1)
            same = got["final_labels"][b, gv] == ref["final_labels"][b, i]
            hit += bool(((d <= 0.5) & same).any())
    return hit / max(total, 1), total


def roi_windows(feats, boxes, valid, strides, pool):
    """Per FPN level, the pixel rectangles that the valid boxes' bilinear
    samples touch on their canonical level, clipped to the map: yields
    (level, image, r0, r1, c0, c1), the last five tensors over the boxes
    with a sample inside the map (inclusive bounds)."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    b, n = boxes.shape[:2]
    lvl = RA.fpn_map_rois_to_levels(boxes).long().clamp(0, len(feats) - 1)
    img = torch.arange(b, device=boxes.device)[:, None].expand(b, n)
    for li, f in enumerate(feats):
        h, w = f.shape[1:3]
        sel = valid & (lvl == li)
        bx = boxes[sel] / strides[li]
        half_y = (bx[:, 3] - bx[:, 1]) / (4 * pool)   # half a sample spacing
        half_x = (bx[:, 2] - bx[:, 0]) / (4 * pool)
        y_lo, y_hi = bx[:, 1] + half_y - 0.5, bx[:, 3] - half_y - 0.5
        x_lo, x_hi = bx[:, 0] + half_x - 0.5, bx[:, 2] - half_x - 0.5
        keep = (y_hi >= 0) & (y_lo <= h - 1) & (x_hi >= 0) & (x_lo <= w - 1)
        r0 = y_lo[keep].clamp(0, h - 1).floor().long()
        r1 = (y_hi[keep].clamp(0, h - 1).floor().long() + 1).clamp(max=h - 1)
        c0 = x_lo[keep].clamp(0, w - 1).floor().long()
        c1 = (x_hi[keep].clamp(0, w - 1).floor().long() + 1).clamp(max=w - 1)
        yield li, img[sel][keep], r0, r1, c0, c1


def roi_bound_ms(feats, boxes, valid, strides, pool):
    """The least time of one ROIAlign launch on the card: the bytes it must
    move over the memory rate (its float32 output, the boxes and validity,
    and the feature pixels its valid boxes' bilinear samples touch, counted
    once per image and level: the union of the roi_windows rectangles).
    Its few operations per byte leave it bound by bytes."""
    import torch
    b, n = boxes.shape[:2]
    c = feats[0].shape[-1]
    touched = 0
    for li, bi, r0, r1, c0, c1 in roi_windows(feats, boxes, valid, strides,
                                              pool):
        f = feats[li]
        h, w = f.shape[1:3]
        diff = torch.zeros(b, h + 1, w + 1, dtype=torch.int32,
                           device=boxes.device)
        one = torch.ones_like(r0, dtype=torch.int32)
        for rr, cc, sign in ((r0, c0, 1), (r0, c1 + 1, -1), (r1 + 1, c0, -1),
                             (r1 + 1, c1 + 1, 1)):
            diff.index_put_((bi, rr, cc), sign * one, accumulate=True)
        cover = diff.cumsum(1).cumsum(2)[:, :h, :w] > 0
        touched += int(cover.sum().item()) * c * f.element_size()
    out_bytes = b * n * pool * pool * c * 4
    return 1e3 * (touched + out_bytes + b * n * 17) / PEAK_BYTES


def forward_kernel_inputs(model, x, out):
    """The inputs of every kernel launch of one forward of ``model`` on
    ``x`` (whose result was ``out``), recomputed: the bottleneck stages
    (backbone_impl "pallas") as (blocks, x, width, c_out, kernel result),
    and the ROIAlign launches (the FPN levels with the proposals, with the
    final boxes, and with add_mask the 14x14 mask crops) as (label, boxes,
    valid, pool). Returns (stages, feats, strides, roi launches)."""
    import torch
    from object_detection_tracking_tpu_torch.models import resnet as TR
    cfg = model.config
    h, w = x.shape[1:3]
    hp, wp, fields, valids = model._static_geometry(h, w)
    stages = []
    real = TR.fused_bottleneck_stage_cuda

    def recording(blocks, xs, width, c_out):
        y = real(blocks, xs, width, c_out)
        stages.append((blocks, xs, width, c_out, y))
        return y

    TR.fused_bottleneck_stage_cuda = recording
    try:
        with torch.inference_mode():
            p23456 = model.backbone(model.preprocess(x, hp, wp))
            props, prop_valid = model._proposals(
                *model._rpn_all_levels(p23456), fields, valids, h, w)
    finally:
        TR.fused_bottleneck_stage_cuda = real
    launches = [("N=%d P=7" % props.shape[1], props, prop_valid, 7),
                ("N=%d P=7" % cfg.result_per_im, out["final_boxes"],
                 out["final_valid"], 7)]
    if cfg.add_mask:
        launches.append(("N=%d P=14" % cfg.result_per_im, out["final_boxes"],
                         out["final_valid"], 14))
    return stages, list(p23456[:4]), cfg.anchor_strides[:4], launches


def main_path_kernel_check(model, x, out, phase, timed=False):
    """Every kernel launch of one bf16 main-path forward, redone on that
    forward's own inputs through the kernel and through the plain version
    (forward_kernel_inputs). The inputs are not unit-normal here, so the
    bounds scale with the plain result's largest magnitude. With
    ``timed``, per ROIAlign launch: median CUDA-event times of the
    wrapper's call and of the plain version, the kernel's own device time
    (torch.profiler), and the launch's bound. Returns {"roi": {...},
    "stage": [...]}."""
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    stages, feats, strides, launches = forward_kernel_inputs(model, x, out)
    res = {"roi": {}, "stage": []}
    for blocks, xs, width, c_out, y in stages:
        rel = stage_rel(str(model.compute_dtype)[6:], len(blocks))
        ref = RS.fused_bottleneck_stage(blocks, xs, width, c_out)
        err = (y.float() - ref.float()).abs().max().item()
        bound = rel * ref.float().abs().max().item()
        if not err <= bound:
            raise AssertionError(f"{phase} stage {tuple(xs.shape)}: max "
                                 f"|kernel - plain| {err} > {bound}")
        res["stage"].append(err)
        log(phase, f"bottleneck stage on the forward's own input "
            f"{tuple(xs.shape)}, {len(blocks)} blocks: max |kernel - plain| "
            f"{err:.4g} (bound {bound:.4g} = {rel:.4g} x max |plain|)")
    for label, boxes, valid, pool in launches:
        def kernel():
            return RA.multilevel_roi_align_cuda(feats, boxes, strides, pool,
                                                valid=valid)

        def plain():
            return RA.multilevel_roi_align(feats, boxes, strides, pool,
                                           valid=valid)
        got = kernel()
        ref = plain()
        err = (got - ref).abs().max().item()
        bound = KERNEL_ATOL * max(1.0, ref.abs().max().item())
        if not err <= bound:
            raise AssertionError(f"{phase} roi_align {label}: max |kernel - "
                                 f"plain| {err} > {bound}")
        if not (got[~valid] == 0).all():
            raise AssertionError(f"{phase} roi_align: invalid slots not 0")
        entry = {"err": err}
        msg = ""
        if timed:
            entry["ms"], entry["plain_ms"] = median_ms([kernel, plain])
            entry["device_ms"] = roi_device_ms(kernel)
            entry["bound_ms"] = roi_bound_ms(feats, boxes, valid, strides,
                                             pool)
            entry["bound_share"] = entry["bound_ms"] / entry["device_ms"]
            msg = (f"; kernel {entry['ms']:.4f} ms, plain "
                   f"{entry['plain_ms']:.4f} ms (median of 15, CUDA events),"
                   f" kernel device {entry['device_ms']:.4f} ms "
                   f"(torch.profiler, mean of 15), bound "
                   f"{entry['bound_ms']:.4f} ms (bytes), "
                   f"{entry['bound_share']:.1%} of it")
        res["roi"][label] = entry
        log(phase, f"roi_align on the bf16 forward's own inputs, {label} "
            f"({int(valid.sum())} valid): max |kernel - plain| {err:.3g} "
            f"(bound {bound:.3g} = {KERNEL_ATOL} x max |plain|){msg}")
    return res


def build_model(cfg, tree, device):
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import params_from_jax
    return params_from_jax(tree, get_model(cfg)).to(device).eval()


def phase_main_path(tmp):
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.params import init_params
    from object_detection_tracking_tpu_torch.runtime import DetectionRunner

    device = torch.device("cuda")
    args = cli.get_args([
        "--video_dir", tmp, "--video_lst_file", os.path.join(tmp, "none"),
        "--use_partial_classes", "--resnet50", "--short_edge_size",
        str(FRAME_H), "--max_size", str(FRAME_W), "--frame_gap",
        str(FRAME_GAP), "--im_batch_size", str(BATCH), "--get_tracking",
        "--tracking_dir", os.path.join(tmp, "tracks"), "--min_confidence",
        "0.0", "--pixel_format", "bgr", "--prefetch", "3"])
    cfg = cli.build_config(args, device)
    assert cfg.compute_dtype == "bfloat16" and cfg.roi_align_impl == "pallas"
    tree = init_params(cfg, seed=0)
    # Random ResNet weights grow activations ~100x by p2 and the RPN then
    # decodes every box off the frame; scaling each residual branch's last
    # BN gamma by 0.2 keeps them in range (widths and shapes unchanged).
    for gname, group in tree["resnet"].items():
        if gname.startswith("group"):
            for blk in group.values():
                blk["conv3"]["bn"]["gamma"] *= 0.2
    t0 = time.perf_counter()
    model = build_model(cfg, tree, device)
    n_params = sum(p.numel() for p in model.parameters())
    log("main", f"R50-FPN partial-COCO, {n_params} params, bf16, built in "
        f"{time.perf_counter() - t0:.2f} s")

    warm = torch.zeros(BATCH, FRAME_H, FRAME_W, 3, dtype=torch.uint8,
                       device=device)
    model(warm)                                   # cuDNN / allocator warm-up
    torch.cuda.synchronize()

    runner = CheckedRunner(DetectionRunner(model), cfg.result_per_im)
    n_frames = FRAME_GAP * BATCH * N_BATCHES
    coco_to_actev = dict(cli.coco_obj_to_actev_obj)
    RA.multilevel_roi_align_cuda.launches = 0
    t0 = time.perf_counter()
    frames = cli.process_video(args, cfg, runner, "synthetic.mp4",
                               cfg.classid2name, coco_to_actev,
                               vcap=SyntheticVideo(n_frames))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = RA.multilevel_roi_align_cuda.launches
    if frames != n_frames // FRAME_GAP or runner.batches != N_BATCHES:
        raise AssertionError(f"{frames} frames in {runner.batches} batches")
    if launches != 2 * runner.batches:
        raise AssertionError(f"roi_align launched {launches} times for "
                             f"{runner.batches} batches, want 2 per batch")
    rows = {}
    for obj in ("Person", "Vehicle"):
        path = os.path.join(tmp, "tracks", "synthetic", obj, "synthetic.txt")
        with open(path) as f:
            lines = [ln for ln in f if ln.strip()]
        rows[obj] = (len(lines), len({ln.split(",")[1] for ln in lines}))
    if runner.dets == 0 or sum(r for r, _ in rows.values()) == 0:
        raise AssertionError(f"no detections or no tracks: {runner.dets} "
                             f"detections, track rows {rows}")
    main = {"frames": frames, "batches": runner.batches, "wall_s": wall,
            "fps": frames / wall, "ms_per_batch": 1e3 * wall / runner.batches,
            "dets_per_frame": runner.dets / frames, "launches": launches,
            "track_rows": rows}
    names = {i: n for n, i in cfg.classname2id.items()}
    by_name = {names[k]: v for k, v in sorted(runner.by_label.items())}
    log("main", f"{frames} frames (1/{FRAME_GAP} of {n_frames}) in "
        f"{runner.batches} batches of {BATCH}: {wall:.3f} s wall, "
        f"{main['fps']:.2f} processed fps, {main['ms_per_batch']:.1f} ms per "
        f"batch (decode + device + Deep SORT, pipelined), "
        f"{main['dets_per_frame']:.1f} detections/frame, roi_align launches "
        f"{launches} (2 per batch), detections by class {by_name}, MOT "
        f"rows/ids {rows}")
    log("main", f"wall split per batch: {1e3 * runner.runner_s / runner.batches:.1f}"
        f" ms in DetectionRunner.run (frame wait, H2D, forward, D2H), "
        f"{1e3 * runner.consumer_s / runner.batches:.1f} ms in the caller "
        f"(Deep SORT, MOT rows), rest {1e3 * (wall - runner.runner_s - runner.consumer_s) / runner.batches:.1f} ms")

    # f32 check: one batch, ROIAlign through the kernel and through the
    # plain version, same weights; TF32 is off, so only ROIAlign differs
    video = SyntheticVideo(BATCH)
    frames8 = np.stack([video.read()[1] for _ in range(BATCH)])
    x = torch.from_numpy(frames8).to(device)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32, tree, device)
    out_k = {k: v.cpu().numpy() for k, v in model32(x).items()}
    model32.config = dataclasses.replace(cfg32, roi_align_impl="xla")
    out_p = {k: v.cpu().numpy() for k, v in model32(x).items()}
    share, total = match_share(out_p, out_k)
    same_slots = float((out_k["final_labels"] == out_p["final_labels"]).mean())
    if not share >= MATCH_MIN:
        raise AssertionError(f"f32 forward: kernel run matches {share:.4f} "
                             f"of {total} plain-run detections < {MATCH_MIN}")
    out_bf = model(x)
    bf_share, _ = match_share(out_p, {k: v.cpu().numpy()
                                      for k, v in out_bf.items()})
    log("main", f"f32 batch, ROIAlign kernel vs plain: {share:.4f} of {total}"
        f" detections matched (bound {MATCH_MIN}), labels equal in "
        f"{same_slots:.4f} of slots; bf16 main path vs f32: {bf_share:.4f} "
        f"matched (information only: random weights)")
    del model32
    check = main_path_kernel_check(model, x, out_bf, "main")
    main["roi_err"] = max(e["err"] for e in check["roi"].values())
    return model, x, main


def phase_profile(model, x, phase="profile", unfused=None):
    """Host wall of one synchronized forward (and of the same forward with
    the unfused backbone, when given), then device time by kernel over two
    forwards under torch.profiler (after one profiled warm-up, which
    absorbs the tracer's start-up). Returns a summary dict."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def host_wall(m):
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            m(x)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        return sorted(walls)[2]

    wall = host_wall(model)
    wall_unfused = host_wall(unfused) if unfused is not None else None
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                model(x)
            torch.cuda.synchronize()
    # kernel events only: CPU ops also carry the device time of the
    # kernels they launch, which would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 2e3
    groups = {}
    for e in events:
        k = e.key.lower()
        g = ("roi_align (csrc)" if "roi_align_fwd" in k else
             "bottleneck_stage (csrc)" if "bneck_conv" in k else
             "conv (cuDNN)" if any(t in k for t in (
                 "fprop", "conv", "xmma", "cutlass", "implicit", "dgrad",
                 "nchw", "nhwc")) else
             "gemm" if "gemm" in k or "sm90_xmma" in k else
             "sort" if "sort" in k or "radix" in k else
             "reduce" if "reduce" in k else
             "copy/cast" if "copy" in k else "elementwise/other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 2e3
    unfused_msg = ("" if wall_unfused is None else
                   f"; unfused backbone {wall_unfused:.1f} ms")
    log(phase, f"one forward of {BATCH} frames: {wall:.1f} ms host wall "
        f"(median of 5, synchronized){unfused_msg}; {total:.1f} ms of kernel "
        f"time (torch.profiler, mean of 2), device busy "
        f"{100 * total / wall:.0f}% of the forward")
    log(phase, "  by kind: " + ", ".join(
        f"{g} {t:.2f} ms" for g, t in sorted(groups.items(),
                                             key=lambda kv: -kv[1])))
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:10]:
        log(phase, f"  {e.self_device_time_total / 2e3:8.3f} ms "
            f"x{e.count // 2:<4d} {e.key[:80]}")
    return {"wall_ms": wall, "wall_unfused_ms": wall_unfused,
            "kernel_ms": total, "by_kind": groups}


def stage_blocks(n, c_in, width, gen):
    """n stride-1 bottleneck blocks on the card (a shortcut conv on the
    first when c_in != 4 * width): msra weights, non-trivial frozen-BN
    statistics (as tests/test_resnet_stage_pallas.py makes them), and each
    residual branch's last BN gamma scaled by 0.2 like the main paths'
    weights."""
    import torch
    from object_detection_tracking_tpu_torch.models.resnet import Bottleneck

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    blocks, c = [], c_in
    with torch.no_grad():
        for _ in range(n):
            blk = Bottleneck(c, width, 1, 1, False, False).cuda()
            for conv in (blk.conv1, blk.conv2, blk.conv3, blk.convshortcut):
                if conv is None:
                    continue
                o, i, kh, kw = conv.weight.shape
                conv.weight.copy_(randn(o, i, kh, kw)
                                  * math.sqrt(2.0 / (i * kh * kw)))
                conv.bn.mean.copy_(0.1 * randn(o))
                conv.bn.variance.copy_(randn(o).abs() + 0.5)
                conv.bn.gamma.copy_(1 + 0.1 * randn(o))
                conv.bn.beta.copy_(0.05 * randn(o))
            blk.conv3.bn.gamma.mul_(0.2)
            blocks.append(blk.eval())
            c = 4 * width
    return blocks


def stage_convs(n, h, w, c_in, width):
    """The convs of one stack at B=8, in launch order: (kind, M, K, N,
    activation elements read, activation elements written)."""
    m, c_out, cin = BATCH * h * w, 4 * width, c_in
    convs = []
    for i in range(n):
        convs.append(("1x1", m, cin, width, m * cin, m * width))
        convs.append(("3x3", m, 9 * width, width, m * width, m * width))
        if i == 0 and cin != c_out:
            convs.append(("1x1", m, cin, c_out, m * cin, m * c_out))
        # conv3 reads l2 and the residual (x or the shortcut's output)
        convs.append(("1x1", m, width, c_out, m * (width + c_out),
                      m * c_out))
        cin = c_out
    return convs


def stage_work(n, h, w, c_in, width, elem_bytes):
    """The work of one stack at B=8. Operations: 2 per multiply-add of
    every conv. Bytes of the stack as one function: x read once, the
    output written once, every folded weight and float32 bias read once.
    The per-conv floor: the launches run one after another, each at the
    larger of its operations over the peak and its bytes over the memory
    rate, where a conv's bytes are its input (and residual) read once,
    its output written once, its weight and bias read once; so l1, l2,
    the shortcut's output and each block's output are each written once
    and read once. Returns (operations, bytes, per-conv floor ms, {kind:
    (operations, per-conv bytes)})."""
    peak = PEAK_BF16_FLOPS if elem_bytes == 2 else PEAK_F32_FLOPS
    convs = stage_convs(n, h, w, c_in, width)
    flops = wbytes = floor_ms = 0
    kinds = {}
    for kind, m, k, nn, reads, writes in convs:
        f = 2 * m * k * nn
        wb = k * nn * elem_bytes + 4 * nn
        b = (reads + writes) * elem_bytes + wb
        flops += f
        wbytes += wb
        floor_ms += 1e3 * max(f / peak, b / PEAK_BYTES)
        kf, kb = kinds.get(kind, (0, 0))
        kinds[kind] = (kf + f, kb + b)
    m = BATCH * h * w
    return (flops, m * (c_in + 4 * width) * elem_bytes + wbytes, floor_ms,
            kinds)


def device_ms(fn, names, runs=3):
    """Device time per call of fn's kernels whose names hold each of
    ``names`` ({group: substring}): torch.profiler over `runs` calls, after
    one profiled warm-up call. Only the kernels' own time: no host
    preamble, no allocation. Returns {group: ms}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for n in (1, runs):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for group, name in names.items():
            if name in e.key:
                out[group] += e.self_device_time_total / 1e3 / runs
    return out


def roi_device_ms(fn):
    """Device time per call of fn's ROIAlign kernel launches (mean of 15)."""
    return device_ms(fn, {"roi": "roi_align_fwd"}, runs=15)["roi"]


def phase_stage():
    """The bottleneck-stage kernel against its plain version at the ActEV
    path's stage shapes, f32 and bf16; bf16 times of kernel, plain version
    and the unfused cuDNN Bottleneck stack."""
    import torch
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for name, h, w, c_in, width, n in STAGES:
        blocks = stage_blocks(n, c_in, width, gen)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            x = torch.randn(BATCH, h, w, c_in, device="cuda",
                            generator=gen).to(dtype)

            def kernel():
                return RS.fused_bottleneck_stage_cuda(blocks, x, width,
                                                      4 * width)

            def plain():
                return RS.fused_bottleneck_stage(blocks, x, width, 4 * width)

            def cudnn():
                with torch.inference_mode():
                    l = x.permute(0, 3, 1, 2)     # channels_last NCHW view
                    for blk in blocks:
                        l = blk(l)
                    return l

            got = kernel()
            torch.cuda.synchronize()
            ref = plain()
            scale = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            rel = stage_rel(dname, n)
            bound = rel * scale
            if got.shape != ref.shape or not err <= bound:
                raise AssertionError(
                    f"bottleneck stage {name} {dname}: max |kernel - plain| "
                    f"{err} > {bound} ({rel:.4g} x {scale})")
            stack_err = (cudnn().permute(0, 2, 3, 1).float()
                         - ref.float()).abs().max().item()
            # the plain version against itself with float64 sums: the same
            # rounding points, the sums in another order and precision
            with torch.inference_mode():
                ref64 = RS.fused_bottleneck_stage(
                    blocks, x, width, 4 * width, torch.float64).float()
            self_err = (ref.float() - ref64).abs().max().item()
            k64_err = (got.float() - ref64).abs().max().item()
            del ref64
            flops, nbytes, floor_ms, kinds = stage_work(
                n, h, w, c_in, width, x.element_size())
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 \
                else PEAK_F32_FLOPS
            t_ops, t_bytes = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES
            r = {"err": err, "scale": scale, "rel_bound": rel,
                 "stack_err": stack_err, "plain_vs_f64sums": self_err,
                 "kernel_vs_f64sums": k64_err,
                 "tflop": flops / 1e12, "gbytes": nbytes / 1e9,
                 "bound_ms": max(t_ops, t_bytes),
                 "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                 "per_conv_floor_ms": floor_ms}
            msg = ""
            if dtype == torch.bfloat16:
                r["ms"], r["plain_ms"], r["cudnn_ms"] = median_ms(
                    [kernel, plain, cudnn])
                r["by_kind"] = {}
                for kind, ms in device_ms(kernel, {
                        "1x1": "bneck_conv1x1",
                        "3x3": "bneck_conv3x3"}).items():
                    kf, kb = kinds[kind]
                    r["by_kind"][kind] = {
                        "ms": ms, "tflop_per_s": kf / ms / 1e9,
                        "gb_per_s": kb / ms / 1e6, "tflop": kf / 1e12,
                        "gbytes": kb / 1e9}
                msg = (f"; kernel {r['ms']:.3f} ms "
                       f"({flops / r['ms'] / 1e9:.1f} TFLOP/s), plain "
                       f"{r['plain_ms']:.3f} ms, unfused cuDNN stack "
                       f"{r['cudnn_ms']:.3f} ms (median of 15, CUDA events); "
                       f"per-conv floor {floor_ms:.3f} ms; by conv kind "
                       f"(torch.profiler, mean of 3): " + ", ".join(
                           f"{k} {v['ms']:.3f} ms ({v['tflop_per_s']:.1f} "
                           f"TFLOP/s, {v['gb_per_s']:.0f} GB/s of its "
                           f"{v['gbytes']:.3f} GB)"
                           for k, v in r["by_kind"].items()))
            results[(name, dname)] = r
            log("stage", f"{name} [{BATCH},{h},{w},{c_in}] width {width} x{n}"
                f" {dname}: max |kernel - plain| {err:.4g} (bound "
                f"{bound:.4g} = {rel:.4g} x {scale:.4g}); vs the plain version"
                f" with float64 sums: plain {self_err:.4g}, kernel "
                f"{k64_err:.4g}; unfused stack vs plain {stack_err:.4g}; "
                f"{flops / 1e12:.3f} TFLOP, "
                f"{nbytes / 1e9:.3f} GB, bound {r['bound_ms']:.3f} ms "
                f"({r['bound_by']}){msg}")
            if dtype == torch.bfloat16 and not r["ms"] < r["cudnn_ms"]:
                raise AssertionError(
                    f"bottleneck stage {name} bf16: kernel {r['ms']:.3f} ms "
                    f"not below the unfused cuDNN stack {r['cudnn_ms']:.3f}")
            del x, got, ref
        del blocks
    return results


def actev_setup(tmp, device):
    """The CLI's arguments, configuration and random weights for the ActEV
    path (phase 7 of the module note), writing under ``tmp``."""
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    from object_detection_tracking_tpu_torch.params import init_params
    args = cli.get_args([
        "--video_dir", tmp, "--video_lst_file", os.path.join(tmp, "none"),
        "--short_edge_size", str(ACTEV_H), "--max_size", str(ACTEV_W),
        "--add_mask", "--frame_gap", str(FRAME_GAP), "--im_batch_size",
        str(BATCH), "--get_tracking", "--tracking_dir",
        os.path.join(tmp, "actev_tracks"), "--min_confidence", "0.0",
        "--pixel_format", "bgr", "--prefetch", "3"])
    cfg = dataclasses.replace(cli.build_config(args, device),
                              backbone_impl="pallas")
    got = (cfg.resnet_depth, cfg.use_dilations, cfg.use_frcnn_class_agnostic,
           cfg.num_class, cfg.add_mask, cfg.compute_dtype, cfg.roi_align_impl)
    if got != (101, True, True, 16, True, "bfloat16", "pallas"):
        raise AssertionError(f"not the CLI's v4 default: {got}")
    tree = init_params(cfg, seed=0)
    for gname, group in tree["resnet"].items():    # as in phase 4
        if gname.startswith("group"):
            for blk in group.values():
                blk["conv3"]["bn"]["gamma"] *= 0.2
    # The random class head (normal, std 0.01) gives 16 near-equal scores
    # and, at seed 0, puts no Person or Vehicle among the top 100: the
    # trackers would get nothing. A +1 bias on those two logits gives them
    # detections to track (widths and shapes unchanged).
    bias = tree["fastrcnn"]["outputs"]["class"]["b"]
    for name in ("Person", "Vehicle"):
        bias[cfg.classname2id[name]] += 1.0
    return args, cfg, tree


def phase_actev(tmp):
    """The CLI's default detector at 1920x1080 with masks and the fused
    backbone, through process_video (phase 7 of the module note)."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.runtime import DetectionRunner

    device = torch.device("cuda")
    args, cfg, tree = actev_setup(tmp, device)
    t0 = time.perf_counter()
    model = build_model(cfg, tree, device)
    n_params = sum(p.numel() for p in model.parameters())
    log("actev", f"R101-FPN v4 + Mask R-CNN head, {n_params} params, bf16, "
        f"backbone_impl pallas (fused groups {model.resnet.fused_groups}), "
        f"built in {time.perf_counter() - t0:.2f} s")
    warm = torch.zeros(BATCH, ACTEV_H, ACTEV_W, 3, dtype=torch.uint8,
                       device=device)
    model(warm)
    torch.cuda.synchronize()
    del warm

    runner = CheckedRunner(DetectionRunner(model), cfg.result_per_im,
                           cfg.num_class, masks=True)
    n_frames = FRAME_GAP * BATCH * N_BATCHES
    RA.multilevel_roi_align_cuda.launches = 0
    RS.fused_bottleneck_stage_cuda.launches = 0
    t0 = time.perf_counter()
    frames = cli.process_video(args, cfg, runner, "actev.mp4",
                               cfg.classid2name, None,
                               vcap=SyntheticVideo(n_frames, h=ACTEV_H,
                                                   w=ACTEV_W))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    roi_n = RA.multilevel_roi_align_cuda.launches
    stage_n = RS.fused_bottleneck_stage_cuda.launches
    if frames != n_frames // FRAME_GAP or runner.batches != N_BATCHES:
        raise AssertionError(f"{frames} frames in {runner.batches} batches")
    if roi_n != 3 * runner.batches or stage_n != 3 * runner.batches:
        raise AssertionError(
            f"{runner.batches} batches launched roi_align {roi_n} and the "
            f"bottleneck stage {stage_n} times, want 3 per batch each")
    rows = {}
    for obj in ("Person", "Vehicle"):
        path = os.path.join(tmp, "actev_tracks", "actev", obj, "actev.txt")
        with open(path) as f:
            lines = [ln for ln in f if ln.strip()]
        rows[obj] = (len(lines), len({ln.split(",")[1] for ln in lines}))
    names = {i: n for n, i in cfg.classname2id.items()}
    by_name = {names.get(k, k): v for k, v in sorted(runner.by_label.items())}
    if runner.dets == 0 or sum(r for r, _ in rows.values()) == 0:
        raise AssertionError(f"no detections or no tracks: {runner.dets} "
                             f"detections {by_name}, track rows {rows}")
    res = {"frames": frames, "batches": runner.batches, "wall_s": wall,
           "fps": frames / wall, "ms_per_batch": 1e3 * wall / runner.batches,
           "roi_launches": roi_n, "stage_launches": stage_n,
           "dets_per_frame": runner.dets / frames, "track_rows": rows,
           "runner_ms": 1e3 * runner.runner_s / runner.batches,
           "caller_ms": 1e3 * runner.consumer_s / runner.batches}
    log("actev", f"{frames} frames (1/{FRAME_GAP} of {n_frames}) of "
        f"{ACTEV_W}x{ACTEV_H} in {runner.batches} batches of {BATCH}: "
        f"{wall:.3f} s wall, {res['fps']:.2f} processed fps, "
        f"{res['ms_per_batch']:.1f} ms per batch, masks [{BATCH},"
        f"{cfg.result_per_im},28,28] in [0,1] every batch, {res['dets_per_frame']:.1f} detections/frame, "
        f"launches: roi_align {roi_n}, bottleneck stage {stage_n} (3 per "
        f"batch each), detections by class {by_name}, MOT rows/ids {rows}")
    log("actev", f"wall split per batch: {res['runner_ms']:.1f} ms in "
        f"DetectionRunner.run, {res['caller_ms']:.1f} ms in the caller "
        f"(Deep SORT, MOT rows)")

    # f32 check: one batch, fused vs unfused backbone, same weights, TF32
    # off: the FPN maps and the detections
    video = SyntheticVideo(BATCH, seed=1, h=ACTEV_H, w=ACTEV_W)
    x = torch.from_numpy(np.stack([video.read()[1] for _ in range(BATCH)])
                         ).to(device)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    fused32 = build_model(cfg32, tree, device)
    unfused32 = build_model(dataclasses.replace(cfg32, backbone_impl="xla"),
                            tree, device)
    hp, wp, _, _ = fused32._static_geometry(ACTEV_H, ACTEV_W)
    with torch.inference_mode():
        img = fused32.preprocess(x, hp, wp)
        fpn_rel = 0.0
        for lvl, (a, b) in enumerate(zip(fused32.backbone(img),
                                         unfused32.backbone(img))):
            rel = ((a - b).abs().max() / b.abs().max()).item()
            if not rel <= FPN_REL:
                raise AssertionError(f"f32 p{lvl + 2}: fused vs unfused "
                                     f"backbone {rel} of max > {FPN_REL}")
            fpn_rel = max(fpn_rel, rel)
        del img
        out_f = {k: v.cpu().numpy() for k, v in fused32(x).items()}
        out_u = {k: v.cpu().numpy() for k, v in unfused32(x).items()}
    share, total = match_share(out_u, out_f)
    if not share >= MATCH_MIN:
        raise AssertionError(f"f32 forward: fused backbone matches "
                             f"{share:.4f} of {total} unfused detections "
                             f"< {MATCH_MIN}")
    # masks of the slots that hold the same detection in both runs
    same = (out_f["final_valid"] & out_u["final_valid"]
            & (out_f["final_labels"] == out_u["final_labels"])
            & (np.abs(out_f["final_boxes"] - out_u["final_boxes"]).max(-1)
               <= 0.5))
    mask_d = float(np.abs(out_f["final_masks"] - out_u["final_masks"])[same]
                   .max())
    log("actev", f"f32 batch, fused vs unfused backbone: FPN p2..p6 within "
        f"{fpn_rel:.3g} of their max (bound {FPN_REL}); {share:.4f} of "
        f"{total} detections matched (bound {MATCH_MIN}); masks of the "
        f"{int(same.sum())} slots with the same detection: max |d| "
        f"{mask_d:.3g} (information)")
    res.update(fpn_rel=fpn_rel, match=share)
    del fused32, unfused32, out_f, out_u
    torch.cuda.empty_cache()

    with torch.inference_mode():
        out = model(x)
    res["check"] = main_path_kernel_check(model, x, out, "actev", timed=True)
    unfused = build_model(dataclasses.replace(cfg, backbone_impl="xla"),
                          tree, device)
    return model, unfused, x, res


def build_kernels(native):
    """Every CUDA source compiled at once, one nvcc each, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    def build(name):
        t0 = time.perf_counter()
        native.load_cuda(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(native.CUDA_SOURCES)) as pool:
        secs = dict(zip(native.CUDA_SOURCES,
                        pool.map(build, native.CUDA_SOURCES)))
    for name, sec in secs.items():
        log("build", f"{name}: nvcc sm_90a and load, {sec:.2f} s")
    log("build", f"all {len(secs)} in parallel: "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in native.build_logs.items():
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] + ": "   # mangled name
            if "registers" in line or "spill" in line:
                log("build", f"  {name}: {kernel}{line.strip()}")
    sass = subprocess.run(
        [native.cuda_tool("cuobjdump"), "-sass",
         native.lib_paths["bottleneck_stage"]], capture_output=True,
        text=True, check=True, timeout=300).stdout
    n_hgmma = len(re.findall(r"\bHGMMA\.", sass))
    n_hmma = len(re.findall(r"\bHMMA\.", sass))
    log("build", f"bottleneck_stage SASS (cuobjdump -sass): {n_hgmma} HGMMA "
        f"(wgmma), {n_hmma} HMMA (mma.sync/WMMA) instructions")
    if n_hgmma == 0:
        raise AssertionError("bottleneck_stage: no HGMMA in its SASS")
    return {"hgmma": n_hgmma, "hmma": n_hmma}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a "
              "CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from object_detection_tracking_tpu_torch import native

    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("device", f"{card}; {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; TF32 off for cuDNN and matmul (f32 checks)")

    sass = build_kernels(native)
    kres = phase_kernels()
    sres = phase_stage()
    with tempfile.TemporaryDirectory() as tmp:
        model, x, main_res = phase_main_path(tmp)
        phase_profile(model, x)
        del model, x
        torch.cuda.empty_cache()
        model, unfused, x, actev = phase_actev(tmp)
    prof = phase_profile(model, x, "actev-profile", unfused=unfused)

    roi = actev["check"]["roi"]
    err = max([r[0] for r in kres.values()] + [main_res["roi_err"]]
              + [r["err"] for r in roi.values()])
    _, k_ms, p_ms, b_ms, d_ms = kres[(1000, torch.bfloat16)]
    _, k100, p100, b100, d100 = kres[(100, torch.bfloat16)]
    bf = [sres[(name, "bfloat16")] for name, *_ in STAGES]
    stage_err = max([r["err"] for r in sres.values()]
                    + actev["check"]["stage"])
    roi_device = sum(r["device_ms"] for r in roi.values())
    roi_bound = sum(r["bound_ms"] for r in roi.values())
    kernels = {"kernels": [{
        "name": "roi_align", "route": "cuda",
        "source": "object_detection_tracking_tpu_torch/csrc/roi_align.cu",
        "replaces": "object_detection_tracking_tpu/ops/pallas/"
                    "roi_align_pallas.py:138",
        "launches": actev["roi_launches"], "max_abs_err": err,
        "ms": sum(r["ms"] for r in roi.values()),
        "device_ms": roi_device,
        "plain_ms": sum(r["plain_ms"] for r in roi.values()),
        "bound_ms": roi_bound,
        "bound_share": roi_bound / roi_device,
        "bound_by": "bytes", "library_ms": None,
        "per_launch": roi,
        "r50_720p": {"launches": main_res["launches"], "ms_n1000": k_ms,
                     "device_ms_n1000": d_ms, "plain_ms_n1000": p_ms,
                     "bound_ms_n1000": b_ms, "ms_n100": k100,
                     "device_ms_n100": d100, "plain_ms_n100": p100,
                     "bound_ms_n100": b100},
        "shapes": "ActEV path, one bf16 forward's own launches (B=8, "
                  "1088x1920 pyramid, C=256): N=1000 P=7, N=100 P=7, "
                  "N=100 P=14; ms (CUDA events around the wrapper), "
                  "device_ms (the kernel alone, torch.profiler), plain_ms "
                  "and bound_ms summed over them"},
        {"name": "bottleneck_stage", "route": "cuda",
         "source": "object_detection_tracking_tpu_torch/csrc/"
                   "bottleneck_stage.cu",
         "replaces": "object_detection_tracking_tpu/ops/pallas/"
                     "resnet_stage_pallas.py:155",
         "launches": actev["stage_launches"], "max_abs_err": stage_err,
         "ms": sum(r["ms"] for r in bf),
         "plain_ms": sum(r["plain_ms"] for r in bf),
         "bound_ms": sum(r["bound_ms"] for r in bf),
         "bound_by": "operations" if all(
             r["bound_by"] == "operations" for r in bf) else "bytes",
         "library_ms": None,
         "cudnn_stack_ms": sum(r["cudnn_ms"] for r in bf),
         "per_conv_floor_ms": sum(r["per_conv_floor_ms"] for r in bf),
         "by_kind": {kind: {
             "ms": sum(r["by_kind"][kind]["ms"] for r in bf),
             "tflop_per_s": sum(r["by_kind"][kind]["tflop"] for r in bf)
             / sum(r["by_kind"][kind]["ms"] for r in bf) * 1e3,
             "gb_per_s": sum(r["by_kind"][kind]["gbytes"] for r in bf)
             / sum(r["by_kind"][kind]["ms"] for r in bf) * 1e3}
             for kind in ("1x1", "3x3")},
         "sass": sass,
         "by_stage": {name: sres[(name, "bfloat16")]
                      for name, *_ in STAGES},
         "shapes": "ActEV path's stages at B=8, 1088x1920, bf16: c2 "
                   "[8,272,480,64] x3, c3 [8,136,240,512] x3, c4 "
                   "[8,68,120,1024] x22; ms, plain_ms, bound_ms, "
                   "per_conv_floor_ms, cudnn_stack_ms and by_kind summed "
                   "over the three"}],
        "actev_path": {k: v for k, v in actev.items() if k != "check"},
        "actev_profile": prof, "card": card}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
