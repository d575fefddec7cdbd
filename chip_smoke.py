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
               zero-area, edge and aspect-5 boxes; and in EfficientDet's
               mode (five levels P3..P7, explicit per-ROI levels, mostly
               not the canonical ones) at d0's shapes (512x512, C=64) and
               d6's (1280x1280, C=384), B=8, N=100, with zero boxes on
               level 0 and boxes on P7's edge; median CUDA-event times
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
  9. train     the training entry point (cli/main.py train, through
               mode_train) with the train CLI's defaults: R101-FPN v4 at
               1920x1080 with the mask head, bf16, B=2, freeze=2, random
               weights from seed 0 (through --load_from), 8 steps on one
               repeated in-memory batch at a constant learning rate,
               checkpoints; every loss finite and the loss falling; B1
               (forward) and B1b (backward) must each launch exactly twice
               per step; the step's time split (forward+loss, backward,
               optimizer) by CUDA events and the peak device memory; B1
               and B1b redone on a step's own inputs against the plain
               version and its autograd, timed as in phase 3 (B1b: two
               launches bitwise equal, no allocation beyond its
               gradients, only its own two kernels in its profile); one
               f32 step
               with the kernels against the plain ROIAlign's autograd
               (losses, every gradient leaf)
 10. effdet    the CLI's EfficientDet default (--is_efficientdet, d0,
               --use_partial_classes, top-k 5000), random weights from seed
               0 with BN statistics calibrated on a synthetic batch, bf16,
               B=8, frame gap 8: synthetic frames of 1280x720 fitted to
               512x288 -> VideoEnqueuer -> DetectionRunner -> Deep SORT on
               Person and Vehicle -> MOT files, through process_video; B1
               must launch once per batch; then one f32 batch with the
               kernel and with the plain ROIAlign (detections equal,
               embeddings within the bound); then the batch's B1 launch
               redone on its own inputs (P3..P7, final boxes, their source
               levels) and timed; the forward's host wall and device time
               by kernel kind; then one bf16 forward of d6 (B=8, 1280x720
               into 1280x1280, 8 BiFPN repeats with sum fusion, C=384)
               with its B1 launch checked the same way; peak memory
 11. effdet-train  EfficientDet training through the train loop (cli/main.py
               train, with the config the JAX quality proof builds:
               model="efficientdet"): d0 at its own 512x512 input, the
               proof's --version 2 --num_class 16, B=8, Adam at 1e-3 with
               clip 10 and a constant LR, bf16, 8 steps on one repeated
               in-memory batch of synthetic rectangles (gt padded to
               --max_gt), checkpoints, the BN calibration before the final
               checkpoint and final.npz (every site's statistics moved off
               the init's); every loss finite, the total falling, positive
               anchors; no B1, B1b or B2 launch (the path has no ROIAlign
               and no ResNet); the step's time split (forward+loss,
               backward, optimizer) by CUDA events, the peak device memory,
               the device's busy share of one step and its kernel time by
               kind; calibrate_bn on the batch writing every BN site; a
               bf16 inference forward with the calibrated weights;
               effdet_anchor_targets on the card equal bit for bit to the
               CPU's on a batch with duplicate force-match writes and
               padded rows; one f32 step at B=2 on the card against the
               same step on this machine's CPU (losses, every gradient
               leaf)
 12. quality   the port's detector quality proof (cli/quality_proof.py) in
               this process, at the JAX proof's widths and settings (160 px
               synthetic scenes rendered in memory with numpy, B=8, f32
               with TF32 off) with the steps and scenes cut and the gates
               at 0 (the gates belong to the committed artifacts): R18-FPN
               Mask R-CNN in hard mode, then EfficientDet-d0; every loss
               finite and the loss falling; B1 and B1b launched twice a
               step in R18 training and B1 three times an image in its
               eval (AP and mask IOU); B1 and B1b held against their plain
               versions on an R18 proof step's own inputs (B=8, f32, box
               head N=512 P=7, mask head fg rows P=14); no kernel launched
               in d0 training;
               AP and mask IOU finite; all of it with cv2 blocked (its
               import fails, the port's modules hold None); the median step
               ms, the wall time, and each committed TORCH_QUALITY_*.json's
               freshness (its tree_hash against the tree's)
 13. tmot      the TMOT tracker (--tracker tmot) on phase 7's path: its
               model (R101-FPN v4, 1920x1080, masks, fused backbone, bf16,
               B=8) and video through process_video, run right after
               phase 8 while the model is at hand; every frame processed, a
               MOT file per tracked class, B1 and B2 launched 3 times a
               batch; B1 and B2 redone on one forward's own inputs against
               their plain versions; the caller's host ms a frame beside
               Deep SORT's from phase 7
 14. track-quality  the port's tracking proof (cli/track_quality_proof.py)
               in this process with cv2 blocked, for Deep SORT and then
               TMOT in one workdir (the second reuses the first one's
               detector): hard mode, 160 px, the video-domain R18 detector
               cut to 50 steps (one epoch), a 24-frame video, gates at 0;
               MOTA, IDF1 and MOTP finite; B1 and B1b launched once a step
               in training, B1 twice an image in eval and twice a batch in
               tracking, B2 never; B1 and B1b held against their plain
               versions on a proof step's own inputs (B=8, f32, box head
               N=512 P=7) and B1 on one tracking forward's (the video's
               first 8 frames); the committed TORCH_TRACK_QUALITY.json's
               freshness
Then one JSON line of kernels, the card line, and the last line:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script imports nothing of JAX: the port must run without it.
"""

import contextlib
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
# EfficientDet: P3..P7, strides 8..128; d0 fits 1280x720 into its 512 input
# (the card has no cv2 to resize, so the synthetic frames come at that
# size), d6 into 1280
EFFDET_STRIDES = (8, 16, 32, 64, 128)
EFFDET_H, EFFDET_W = 288, 512
# phase 3's five-level B1 cases: (model, input size, C = fpn_filters)
EFFDET_ROI_CASES = (("d0", 512, 64), ("d6", 1280, 384))
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
# training phase: full width, B=2, steps on one repeated batch, and the
# timed steps after them
TRAIN_BATCH, TRAIN_STEPS, TRAIN_TIMED = 2, 8, 5
# B1b vs plain autograd, as a share of the level's max |plain|: the same
# float32 products, added in another (fixed) order; see
# tests/test_torch_kernels_cuda.py
B1B_REL = 1e-5
# one f32 train step, trainable kernels vs the plain ROIAlign's autograd:
# the losses agree to float32 rounding; the gradients differ only by the
# order of B1b's float32 additions, which can flip a relu input or max-pool
# tie within ~1e-6 of zero upstream (tests/test_torch_train_grads.py sees
# such flips move a leaf by up to 7.2e-3 of its max between the port and
# JAX on the CPU; on an H100 they have moved one by 6.93e-5)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-4, 1e-3
# EfficientDet training (phase 11): the model and its own input size, the
# JAX quality proof's batch, the steps on one repeated batch, the f32
# card-vs-CPU step's batch
EFFDET_TRAIN, EFFDET_TRAIN_SIZE = "efficientdet-d0", 512
EFFDET_TRAIN_BATCH, EFFDET_TRAIN_STEPS, EFFDET_F32_BATCH = 8, 8, 2
# quality phase (12): the proof's flags, with scenes and steps cut
QUALITY_RUNS = (
    ("r18-mask", ["--hard", "--add_mask", "--train_images", "64",
                  "--val_images", "16", "--steps", "150"]),
    ("d0", ["--detector", "efficientdet-d0", "--train_images", "64",
            "--val_images", "16", "--steps", "60"]))
QUALITY_ARTIFACTS = ("TORCH_QUALITY_R18.json", "TORCH_QUALITY_MASK.json",
                     "TORCH_QUALITY_EFFDET.json")
# tracking-proof phase (14): JAX r05's hard settings, the steps (one epoch
# of the proof's 400 scenes at B=8) and the video cut, the gates at 0; a
# 50-step detector scores under the proof's 0.7, so every detection goes
# to the trackers
TRACK_QUALITY_FLAGS = ["--hard", "--steps", "50", "--num_frames", "24",
                       "--min_confidence", "0", "--min_ap", "0",
                       "--min_mota", "0", "--min_idf1", "0",
                       "--min_class_mota", "0"]
# gradient leaves that vanish in exact arithmetic: batch-statistics BN
# removes any per-channel constant added before it, so the bias of a conv
# that feeds a BN and the beta of each MBConv's project BN (its map
# reaches BNs only through 1x1 convs) take float32 rounding noise on any
# device; they must stay within NOISE_SHARE of the largest leaf gradient
# (tests/test_torch_effdet_train.py measures up to 1.1e-6 against JAX)
INVARIANT_LEAF = re.compile(
    r"(^resample/p6|/resample_\d+_\d+_\d+|/fnode\d+/pw|_net/conv\d+/pw)/b$"
    r"|^backbone/group\d+/block\d+/project/bn/beta$")
NOISE_SHARE = 1e-5
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
    for name, size, c in EFFDET_ROI_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            results[(name, dtype)] = effdet_roi_check(gen, name, size, c,
                                                      dtype)
    return results


def effdet_roi_case(gen, size, c, dtype, n=100):
    """EfficientDet's B1 inputs at B=8: P3..P7 of a size x size input, n
    boxes per image with explicit levels drawn from 0..4 (mostly not the
    canonical level), two boxes on P7's last row and column, one whole
    image on P3, and JAX's invalid slots: the last 10 boxes zero on level
    0."""
    import torch
    feats = [torch.randn(BATCH, size // s, size // s, c, device="cuda",
                         generator=gen).to(dtype) for s in EFFDET_STRIDES]
    xy = torch.rand(BATCH, n, 2, device="cuda", generator=gen) * size
    wh = 4.0 * torch.exp(torch.rand(BATCH, n, 2, device="cuda",
                                    generator=gen) * math.log(size / 8.0))
    boxes = torch.cat([xy, xy + wh], -1).clamp(0, size)
    levels = torch.randint(0, 5, (BATCH, n), device="cuda", generator=gen,
                           dtype=torch.int32)
    boxes[:, 0] = torch.tensor([size - 128.0, size - 128.0, size, size])
    boxes[:, 1] = torch.tensor([0.0, size - 64.0, size / 2.0, size])
    levels[:, :2] = 4
    boxes[:, 2] = torch.tensor([0.0, 0.0, size, size])
    levels[:, 2] = 0
    boxes[:, -10:] = 0.0
    levels[:, -10:] = 0
    return feats, boxes.contiguous(), levels


def effdet_roi_check(gen, name, size, c, dtype):
    """Phase 3's five-level, explicit-level case at EfficientDet ``name``'s
    shapes: kernel vs plain (bound KERNEL_ATOL on unit-normal features),
    zero boxes pooled to 0, P7's edge read; times and bound as for the
    four-level cases. Returns (err, ms, plain ms, bound ms, device ms)."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    feats, boxes, levels = effdet_roi_case(gen, size, c, dtype)
    disagree = (levels != RA.fpn_map_rois_to_levels(boxes)).float().mean()

    def kernel():
        return RA.multilevel_roi_align_cuda(feats, boxes, EFFDET_STRIDES, 7,
                                            levels=levels)

    def plain():
        return RA.multilevel_roi_align(feats, boxes, EFFDET_STRIDES, 7,
                                       levels=levels)
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = (got - ref).abs().max().item()
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"roi_align {name} 5 levels {dtype}: max "
                             f"|kernel - plain| {err} > {KERNEL_ATOL}")
    if got[:, -10:].abs().max().item() != 0.0 \
            or got[:, :2].abs().max().item() == 0.0:
        raise AssertionError(f"roi_align {name}: zero boxes not 0 or P7's "
                             f"edge boxes read nothing")
    k_ms, p_ms = median_ms([kernel, plain])
    d_ms = roi_device_ms(kernel)
    b_ms = roi_bound_ms(feats, boxes, torch.ones(boxes.shape[:2], dtype=torch
                                                 .bool, device="cuda"),
                        EFFDET_STRIDES, 7, levels)
    log("kernels", f"roi_align {name} 5 levels P3..P7 of {size}x{size}, C={c}"
        f", N=100, explicit levels ({disagree.item():.0%} not canonical) "
        f"{str(dtype)[6:]}: max_abs_err {err:.3g} (bound {KERNEL_ATOL}), "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of 15, CUDA "
        f"events), kernel device {d_ms:.4f} ms (torch.profiler, mean of "
        f"15), bound {b_ms:.4f} ms (bytes), {b_ms / d_ms:.1%} of it")
    return err, k_ms, p_ms, b_ms, d_ms


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

    def __init__(self, runner, r, n_labels=6, masks=False, feat_dim=256):
        self.runner, self.r = runner, r
        self.n_labels, self.masks = n_labels, masks
        self.feat_dim = feat_dim
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
                      "pooled_box_feat": ((b, r, self.feat_dim),
                                          np.float32)}
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


def roi_touched_bytes(feats, boxes, valid, strides, pool, elem_bytes=None,
                      levels=None):
    """Bytes of the feature pixels that the valid boxes' bilinear taps read
    on their levels (``levels``, else the canonical ones), counted once per
    image and level, at ``elem_bytes`` per channel (the features' own by
    default). A box reads the two neighbour rows of each of its in-map
    y-samples crossed with the two neighbour columns of each in-map
    x-sample (the plain version's float32 sample coordinates): a product
    of a row set and a column set, which skips the pixels between samples
    more than a pixel apart (a large box on a fine level); the union over
    an image's boxes is one matrix product of those sets."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    b, n = boxes.shape[:2]
    c = feats[0].shape[-1]
    dev = boxes.device
    lvl = RA.fpn_map_rois_to_levels(boxes) if levels is None else levels
    lvl = lvl.long().clamp(0, len(feats) - 1)
    stride = torch.tensor(list(strides), dtype=torch.float32, device=dev)
    fb = boxes / stride[lvl][..., None]
    ys = RA._sample_grid(fb[..., 1], fb[..., 3], 2 * pool)
    xs = RA._sample_grid(fb[..., 0], fb[..., 2], 2 * pool)

    def taps(s, extent, sel):
        """[B, N, extent] float: 1 where a selected box reads that row
        (column)."""
        inside = (s >= 0) & (s <= extent - 1) & sel[..., None]
        lo = torch.floor(s).long().clamp(0, extent - 1)
        hi = (lo + 1).clamp(max=extent - 1)
        m = torch.zeros(b, n, extent + 1, device=dev)
        for idx in (lo, hi):
            m.scatter_(-1, torch.where(inside, idx, extent), 1.0)
        return m[..., :extent]

    touched = 0
    for li, f in enumerate(feats):
        h, w = f.shape[1:3]
        sel = valid & (lvl == li)
        cover = torch.einsum("bny,bnx->byx", taps(ys, h, sel),
                             taps(xs, w, sel)) > 0
        touched += int(cover.sum().item()) * c * (elem_bytes
                                                  or f.element_size())
    return touched


def roi_bound_ms(feats, boxes, valid, strides, pool, levels=None):
    """The least time of one ROIAlign launch on the card: the bytes it must
    move over the memory rate (its float32 output, the boxes, validity and
    explicit levels, and the feature pixels its valid boxes' bilinear samples touch
    on their levels, counted once per image and level:
    roi_touched_bytes). Its few operations per byte leave it bound by
    bytes."""
    b, n = boxes.shape[:2]
    c = feats[0].shape[-1]
    touched = roi_touched_bytes(feats, boxes, valid, strides, pool,
                                levels=levels)
    out_bytes = b * n * pool * pool * c * 4
    per_roi = 17 if levels is None else 21    # box, valid flag, level
    return 1e3 * (touched + out_bytes + b * n * per_roi) / PEAK_BYTES


def roi_bwd_bound_ms(feats, boxes, strides, pool):
    """The least time of one ROIAlign backward launch (B1b), the larger of
    its bytes and its operations: grad_out read once (float32), the boxes
    and levels read once, every gradient element written once in the
    features' dtype, over the memory rate; one multiply and one add per
    channel for each of the 4 neighbours of the 4 samples of every bin,
    over the float32 peak. Bound by bytes at the training shapes."""
    b, n = boxes.shape[:2]
    c = feats[0].shape[-1]
    elems = sum(f.numel() for f in feats)
    nbytes = (b * n * pool * pool * c * 4 + b * n * 20
              + elems * feats[0].element_size())
    flops = 2 * b * n * pool * pool * 16 * c
    return 1e3 * max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS)


def roi_bwd_design_ms(feats, boxes, strides, pool, levels):
    """The bytes that B1b's design moves beyond its bound
    (roi_bwd_bound_ms), over the memory rate: each output tile block
    (RA.BWD_TILE pixels) reads the grad_out rows of the bins whose taps
    reach it, so a bin whose taps reach k > 1 tiles is read k - 1 times more
    than once; and the plan's scratch (16 bytes per ROI, 4 per tile) is
    written and read once. The tile blocks' scans of the footprints hit L2
    and are not counted. Not a bound of the function: a design that reads
    each bin once need not move them."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    dev = boxes.device
    lvl = levels.long().clamp(0, len(feats) - 1)
    stride = torch.tensor(list(strides), dtype=torch.float32, device=dev)
    fb = boxes / stride[lvl][..., None]

    def tiles_per_bin(lo, hi, extent, tile):
        """[B, N, pool]: the tile rows (or columns) that each bin row's
        taps reach."""
        s = RA._sample_grid(lo, hi, 2 * pool)
        ext = extent[lvl][..., None]
        inside = (s >= 0) & (s <= (ext - 1).float())
        low = torch.minimum(torch.floor(s).long().clamp_min(0), ext - 1)
        up = torch.minimum(low + 1, ext - 1)
        t = torch.stack([low // tile, up // tile], -1)     # [B, N, 2P, 2]
        t = torch.where(inside[..., None], t, -1)
        t = t.reshape(*t.shape[:2], pool, 4).sort(-1).values
        new = torch.cat([t[..., :1] >= 0, (t[..., 1:] != t[..., :-1])
                         & (t[..., 1:] >= 0)], -1)
        return new.sum(-1)
    th, tw = RA.BWD_TILE
    ny = tiles_per_bin(fb[..., 1], fb[..., 3], torch.tensor(
        [f.shape[1] for f in feats], device=dev), th)
    nx = tiles_per_bin(fb[..., 0], fb[..., 2], torch.tensor(
        [f.shape[2] for f in feats], device=dev), tw)
    tiles = ny[..., :, None] * nx[..., None, :]             # [B, N, P, P]
    c = feats[0].shape[-1]
    rereads = int((tiles - 1).clamp_min(0).sum().item()) * c * 4
    pairs = boxes.shape[0] * sum(-(-f.shape[1] // th) * -(-f.shape[2] // tw)
                                 for f in feats)
    scratch = 16 * boxes.shape[0] * boxes.shape[1] + 4 * pairs
    return 1e3 * (rereads + 2 * scratch) / PEAK_BYTES


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


def check_roi_launch(phase, label, feats, strides, boxes, valid, pool,
                     timed, levels=None):
    """One ROIAlign launch redone on its own inputs (its explicit
    ``levels``, if it had them) through the kernel and the plain version;
    the bound scales with the plain result's largest magnitude. With
    ``timed``: median CUDA-event times of the wrapper's call and of the
    plain version, the kernel's own device time (torch.profiler), and the
    launch's bound. Returns a dict."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA

    def kernel():
        return RA.multilevel_roi_align_cuda(feats, boxes, strides, pool,
                                            valid=valid, levels=levels)

    def plain():
        return RA.multilevel_roi_align(feats, boxes, strides, pool,
                                       valid=valid, levels=levels)
    got = kernel()
    ref = plain()
    err = (got - ref).abs().max().item()
    bound = KERNEL_ATOL * max(1.0, ref.abs().max().item())
    if not err <= bound:
        raise AssertionError(f"{phase} roi_align {label}: max |kernel - "
                             f"plain| {err} > {bound}")
    if valid is not None and not (got[~valid] == 0).all():
        raise AssertionError(f"{phase} roi_align: invalid slots not 0")
    entry = {"err": err}
    msg = ""
    if timed:
        entry["ms"], entry["plain_ms"] = median_ms([kernel, plain])
        entry["device_ms"] = roi_device_ms(kernel)
        entry["bound_ms"] = roi_bound_ms(
            feats, boxes, torch.ones(boxes.shape[:2], dtype=torch.bool,
                                     device=boxes.device)
            if valid is None else valid, strides, pool, levels)
        entry["bound_share"] = entry["bound_ms"] / entry["device_ms"]
        msg = (f"; kernel {entry['ms']:.4f} ms, plain "
               f"{entry['plain_ms']:.4f} ms (median of 15, CUDA events),"
               f" kernel device {entry['device_ms']:.4f} ms "
               f"(torch.profiler, mean of 15), bound "
               f"{entry['bound_ms']:.4f} ms (bytes), "
               f"{entry['bound_share']:.1%} of it")
    n_valid = boxes.shape[0] * boxes.shape[1] if valid is None \
        else int(valid.sum())
    log(phase, f"roi_align on the {phase} path's own inputs, {label} "
        f"({n_valid} valid): max |kernel - plain| {err:.3g} "
        f"(bound {bound:.3g} = {KERNEL_ATOL} x max |plain|){msg}")
    return entry


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
        res["roi"][label] = check_roi_launch(phase, label, feats, strides,
                                             boxes, valid, pool, timed)
    return res


def build_model(cfg, tree, device, model_name=None):
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import params_from_jax
    return params_from_jax(tree, get_model(cfg, model_name)).to(
        device).eval()


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
    unfused_msg = ("" if wall_unfused is None else
                   f"; unfused backbone {wall_unfused:.1f} ms")
    total, groups = kernel_kinds(prof, 2)
    log(phase, f"one forward of {BATCH} frames: {wall:.1f} ms host wall "
        f"(median of 5, synchronized){unfused_msg}; {total:.1f} ms of kernel "
        f"time (torch.profiler, mean of 2), device busy "
        f"{100 * total / wall:.0f}% of the forward")
    log_kernel_kinds(phase, prof, 2, groups)
    return {"wall_ms": wall, "wall_unfused_ms": wall_unfused,
            "kernel_ms": total, "by_kind": groups}


def _cuda_events(prof):
    """The profile's kernel events only: CPU ops also carry the device
    time of the kernels they launch, and a user annotation's device span
    (the optimizer's ``Optimizer.step#Adam.step``) covers kernels listed
    on their own, which would count them twice."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_kinds(prof, runs):
    """(kernel ms per run, {kind: ms per run}) of a torch.profiler
    profile over ``runs`` runs."""
    events = _cuda_events(prof)
    total = sum(e.self_device_time_total for e in events) / 1e3 / runs
    groups = {}
    for e in events:
        k = e.key.lower()
        g = ("roi_align (csrc)" if "roi_align_fwd" in k else
             "bottleneck_stage (csrc)" if "bneck_conv" in k else
             "conv (cuDNN)" if any(t in k for t in (
                 "fprop", "conv", "xmma", "cutlass", "implicit", "dgrad",
                 "wgrad", "nchw", "nhwc")) else
             "gemm" if "gemm" in k or "sm90_xmma" in k else
             "sort" if "sort" in k or "radix" in k else
             "reduce" if "reduce" in k else
             "copy/cast" if "copy" in k else "elementwise/other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 \
            / runs
    return total, groups


def log_kernel_kinds(phase, prof, runs, groups):
    """Logs the kinds' times and the ten slowest kernels of a profile."""
    log(phase, "  by kind: " + ", ".join(
        f"{g} {t:.2f} ms" for g, t in sorted(groups.items(),
                                             key=lambda kv: -kv[1])))
    events = sorted(_cuda_events(prof),
                    key=lambda e: -e.self_device_time_total)
    for e in events[:10]:
        log(phase, f"  {e.self_device_time_total / 1e3 / runs:8.3f} ms "
            f"x{e.count // runs:<4d} {e.key[:80]}")


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


def device_ms(fn, names, runs=3, others=None):
    """Device time per call of fn's kernels whose names hold each of
    ``names`` ({group: substring}): torch.profiler over `runs` calls, after
    one profiled warm-up call. Only the kernels' own time: no host
    preamble, no allocation. Returns {group: ms}; the names of the other
    device activities (kernels, memsets, copies) with time are appended to
    ``others`` when given."""
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
        hit = False
        for group, name in names.items():
            if name in e.key:
                out[group] += e.self_device_time_total / 1e3 / runs
                hit = True
        if not hit and others is not None and e.self_device_time_total > 0:
            others.append(e.key)
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


def actev_args(tmp, tracking_dir, *extra):
    """The CLI's arguments for the ActEV path (phase 7 of the module note),
    with MOT files under ``tracking_dir`` and ``extra`` flags."""
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    return cli.get_args([
        "--video_dir", tmp, "--video_lst_file", os.path.join(tmp, "none"),
        "--short_edge_size", str(ACTEV_H), "--max_size", str(ACTEV_W),
        "--add_mask", "--frame_gap", str(FRAME_GAP), "--im_batch_size",
        str(BATCH), "--get_tracking", "--tracking_dir", tracking_dir,
        "--min_confidence", "0.0", "--pixel_format", "bgr", "--prefetch",
        "3", *extra])


def drive_actev(args, cfg, model, name):
    """Phase 7's video (N_BATCHES batches of BATCH 1920x1080 frames at
    FRAME_GAP) through the CLI's process_video with ``args``, the launch
    counts set to 0 just before; fails unless every frame is processed, B1
    and B2 launch 3 times a batch each, and each tracked class has a MOT
    file. Returns (runner, frames, wall s, B1 launches, B2 launches, MOT
    (rows, ids) by class)."""
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.runtime import DetectionRunner

    runner = CheckedRunner(DetectionRunner(model), cfg.result_per_im,
                           cfg.num_class, masks=True)
    n_frames = FRAME_GAP * BATCH * N_BATCHES
    RA.multilevel_roi_align_cuda.launches = 0
    RS.fused_bottleneck_stage_cuda.launches = 0
    t0 = time.perf_counter()
    frames = cli.process_video(args, cfg, runner, name + ".mp4",
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
    for obj in args.tracking_objs.split(","):
        path = os.path.join(args.tracking_dir, name, obj, name + ".txt")
        with open(path) as f:
            lines = [ln for ln in f if ln.strip()]
        rows[obj] = (len(lines), len({ln.split(",")[1] for ln in lines}))
    return runner, frames, wall, roi_n, stage_n, rows


def actev_setup(tmp, device):
    """The CLI's arguments, configuration and random weights for the ActEV
    path (phase 7 of the module note), writing under ``tmp``."""
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    from object_detection_tracking_tpu_torch.params import init_params
    args = actev_args(tmp, os.path.join(tmp, "actev_tracks"))
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

    n_frames = FRAME_GAP * BATCH * N_BATCHES
    runner, frames, wall, roi_n, stage_n, rows = drive_actev(
        args, cfg, model, "actev")
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


def phase_tmot(tmp, model, x, actev):
    """The TMOT tracker on the ActEV path: phase 7's model and video through
    process_video with --tracker tmot, its checks, and B1 and B2 redone on
    one bf16 forward's own inputs (phase 13 of the module note)."""
    import torch

    cfg = model.config
    args = actev_args(tmp, os.path.join(tmp, "tmot_tracks"), "--tracker",
                      "tmot")
    runner, frames, wall, roi_n, stage_n, rows = drive_actev(
        args, cfg, model, "tmot")
    tmot_ms = 1e3 * runner.consumer_s / frames
    ds_ms = actev["caller_ms"] / BATCH
    res = {"frames": frames, "batches": runner.batches, "wall_s": wall,
           "fps": frames / wall, "roi_launches": roi_n,
           "stage_launches": stage_n, "track_rows": rows,
           "caller_ms_per_frame": tmot_ms,
           "deep_sort_caller_ms_per_frame": ds_ms,
           "runner_ms": 1e3 * runner.runner_s / runner.batches}
    log("tmot", f"--tracker tmot: {frames} frames of {ACTEV_W}x{ACTEV_H} in "
        f"{runner.batches} batches of {BATCH}: {wall:.3f} s wall, "
        f"{res['fps']:.2f} processed fps; launches: roi_align {roi_n}, "
        f"bottleneck stage {stage_n} (3 per batch each); MOT rows/ids "
        f"{rows}")
    log("tmot", f"host ms a frame in the caller (tracker, MOT rows): TMOT "
        f"{tmot_ms:.2f}, Deep SORT {ds_ms:.2f} (phase 7); random weights "
        f"make the detection load an artefact (PERF.md section 7)")
    with torch.inference_mode():
        out = model(x)
    res["check"] = main_path_kernel_check(model, x, out, "tmot")
    return res


def calibrate_bn(model, x):
    """Random EfficientNet and BiFPN weights with the init's identity BN
    statistics shrink the activations ~100x at every depthwise conv, and
    every score then sits at the class prior: set each BN site's
    statistics, in order, to those of its input on the batch ``x`` (one
    mean and variance per site, over all channels), as trained statistics
    would keep the features at unit scale. Widths and shapes unchanged."""
    import torch
    from object_detection_tracking_tpu_torch.ops.norm import frozen_bn

    def calibrating(bn, t):
        tf = t.float()
        bn.mean.fill_(tf.mean().item())
        bn.variance.fill_(tf.var(unbiased=False).item())
        return frozen_bn(bn, t)
    with torch.no_grad():
        model.heads(model.features(x, bn=calibrating), bn=calibrating)


def effdet_setup(tmp, device, name, h, w):
    """The CLI's EfficientDet arguments (--is_efficientdet
    --use_partial_classes, top-k 5000), its configuration, and random
    weights from seed 0 whose BN statistics are calibrated on a synthetic
    batch of h x w frames (calibrate_bn, in float32); as phase 4 does for
    ResNet, each MBConv's project BN gamma is scaled by 0.2. Writes under
    ``tmp``."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            params_to_jax)
    args = cli.get_args([
        "--video_dir", tmp, "--video_lst_file", os.path.join(tmp, "none"),
        "--is_efficientdet", "--efficientdet_modelname", name,
        "--use_partial_classes", "--frame_gap", str(FRAME_GAP),
        "--im_batch_size", str(BATCH), "--get_tracking", "--tracking_dir",
        os.path.join(tmp, "effdet_tracks"), "--min_confidence", "0.0",
        "--pixel_format", "bgr", "--prefetch", "3"])
    cfg = cli.build_config(args, device)
    got = (cfg.efficientdet_name, cfg.compute_dtype, cfg.roi_align_impl,
           cfg.efficientdet_max_detection_topk, cfg.num_class,
           len(cfg.partial_classes))
    if got != (name, "bfloat16", "pallas", 5000, 81, 5):
        raise AssertionError(f"not the CLI's EfficientDet default: {got}")
    tree = init_params(cfg, seed=0, model_name="efficientdet")
    for gname, group in tree["backbone"].items():
        if gname.startswith("group"):
            for blk in group.values():
                blk["project"]["bn"]["gamma"] *= 0.2
    cal = build_model(dataclasses.replace(cfg, compute_dtype="float32"),
                      tree, device, "efficientdet")
    video = SyntheticVideo(BATCH, seed=3, h=h, w=w)
    calibrate_bn(cal, torch.from_numpy(
        np.stack([video.read()[1] for _ in range(BATCH)])).to(device))
    tree = params_to_jax(cal)
    del cal
    torch.cuda.empty_cache()
    return args, cfg, tree


def effdet_launch_inputs(model, x):
    """The inputs of the B1 launch of one EfficientDet forward on ``x``,
    recomputed: (P3..P7 as NHWC, final boxes, their source levels)."""
    import torch
    h, w = x.shape[1:3]
    with torch.inference_mode():
        feats = model.features(x)
        cls_flat, box_flat = model.flat_heads(*model.heads(feats))
        fb, _, _, _, flv = model.postprocess(cls_flat, box_flat, (h, w))
        return ([f.permute(0, 2, 3, 1).contiguous() for f in feats], fb,
                flv)


def phase_effdet(tmp):
    """The CLI's EfficientDet default (d0, partial COCO) through
    process_video, its checks, then one d6 forward (phase 10 of the module
    note). Returns a summary dict."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.runtime import DetectionRunner

    device = torch.device("cuda")
    args, cfg, tree = effdet_setup(tmp, device, "efficientdet-d0", EFFDET_H,
                                   EFFDET_W)
    model = build_model(cfg, tree, device, "efficientdet")
    n_params = sum(p.numel() for p in model.parameters())
    log("effdet", f"EfficientDet-d0 partial-COCO ({model.backbone_name}, "
        f"BiFPN {model.fpn_filters} x{model.fpn_repeats} {model.fusion}, "
        f"heads x{model.head_repeats}), {n_params} params, bf16, "
        f"{EFFDET_W}x{EFFDET_H} frames into {model.image_size}x"
        f"{model.image_size}, BN calibrated on a synthetic batch")
    warm = torch.zeros(BATCH, EFFDET_H, EFFDET_W, 3, dtype=torch.uint8,
                       device=device)
    model(warm)
    torch.cuda.synchronize()
    del warm

    n_labels = len(cfg.partial_classes) + 1
    runner = CheckedRunner(DetectionRunner(model), cfg.result_per_im,
                           n_labels, feat_dim=model.fpn_filters)
    n_frames = FRAME_GAP * BATCH * N_BATCHES
    torch.cuda.reset_peak_memory_stats()
    RA.multilevel_roi_align_cuda.launches = 0
    t0 = time.perf_counter()
    frames = cli.process_video(args, cfg, runner, "effdet.mp4",
                               cfg.classid2name,
                               dict(cli.coco_obj_to_actev_obj),
                               vcap=SyntheticVideo(n_frames, h=EFFDET_H,
                                                   w=EFFDET_W))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    roi_n = RA.multilevel_roi_align_cuda.launches
    if frames != n_frames // FRAME_GAP or runner.batches != N_BATCHES:
        raise AssertionError(f"{frames} frames in {runner.batches} batches")
    if roi_n != runner.batches:
        raise AssertionError(f"roi_align launched {roi_n} times for "
                             f"{runner.batches} batches, want 1 per batch")
    rows = {}
    for obj in ("Person", "Vehicle"):
        path = os.path.join(tmp, "effdet_tracks", "effdet", obj,
                            "effdet.txt")
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
           "roi_launches": roi_n, "detections": runner.dets,
           "dets_per_frame": runner.dets / frames, "track_rows": rows,
           "runner_ms": 1e3 * runner.runner_s / runner.batches,
           "caller_ms": 1e3 * runner.consumer_s / runner.batches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("effdet", f"{frames} frames (1/{FRAME_GAP} of {n_frames}) in "
        f"{runner.batches} batches of {BATCH}: {wall:.3f} s wall, "
        f"{res['fps']:.2f} processed fps, {res['ms_per_batch']:.1f} ms per "
        f"batch ({res['runner_ms']:.1f} in DetectionRunner.run, "
        f"{res['caller_ms']:.1f} in the caller), {runner.dets} detections "
        f"({res['dets_per_frame']:.1f}/frame) by class {by_name}, roi_align "
        f"launches {roi_n} (1 per batch), MOT rows/ids {rows}, peak "
        f"{res['peak_gib']:.2f} GiB")

    # f32 check: one batch with the kernel and with the plain ROIAlign, TF32
    # off. B1 is the forward's last op: the detections must be the same,
    # and the embeddings within KERNEL_ATOL of their largest magnitude
    video = SyntheticVideo(BATCH, seed=1, h=EFFDET_H, w=EFFDET_W)
    x = torch.from_numpy(np.stack([video.read()[1] for _ in range(BATCH)])
                         ).to(device)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = build_model(cfg32, tree, device, "efficientdet")
    out_k = model32(x)
    model32.config = dataclasses.replace(cfg32, roi_align_impl="xla")
    out_p = model32(x)
    for k in ("final_boxes", "final_labels", "final_probs", "final_valid"):
        if not torch.equal(out_k[k], out_p[k]):
            raise AssertionError(f"f32 forward, ROIAlign kernel vs plain: "
                                 f"{k} differ")
    scale = out_p["pooled_box_feat"].abs().max().item()
    emb_err = (out_k["pooled_box_feat"] - out_p["pooled_box_feat"]).abs() \
        .max().item()
    if not emb_err <= KERNEL_ATOL * max(1.0, scale):
        raise AssertionError(f"f32 forward: embeddings differ by {emb_err}")
    n_valid = int(out_p["final_valid"].sum())
    log("effdet", f"f32 batch, ROIAlign kernel vs plain: detections equal "
        f"({n_valid} valid), pooled_box_feat max |d| {emb_err:.3g} (bound "
        f"{KERNEL_ATOL} x max(1, {scale:.3g}))")
    del model32, out_k, out_p
    torch.cuda.empty_cache()

    feats, boxes, levels = effdet_launch_inputs(model, x)
    res["roi"] = check_roi_launch("effdet", "d0 P3..P7 C=64 N=100 P=7",
                                  feats, EFFDET_STRIDES, boxes, None, 7,
                                  timed=True, levels=levels)
    res["roi"]["level_counts"] = torch.bincount(
        levels.flatten().long(), minlength=5).tolist()
    res["profile"] = phase_profile(model, x, "effdet-profile")
    del model, x, feats, boxes, levels
    torch.cuda.empty_cache()

    # one bf16 forward of d6 (B=8, 1280x720 frames into 1280x1280, 8 BiFPN
    # repeats with sum fusion, C=384) and its B1 launch
    _, cfg6, tree6 = effdet_setup(tmp, device, "efficientdet-d6", FRAME_H,
                                  FRAME_W)
    model6 = build_model(cfg6, tree6, device, "efficientdet")
    if (model6.fusion, model6.fpn_repeats, model6.fpn_filters) != \
            ("sum", 8, 384):
        raise AssertionError("not d6")
    x6 = torch.from_numpy(np.stack([SyntheticVideo(BATCH, seed=2).read()[1]
                                    for _ in range(BATCH)])).to(device)
    model6(x6)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    RA.multilevel_roi_align_cuda.launches = 0
    out6 = model6(x6)
    torch.cuda.synchronize()
    if RA.multilevel_roi_align_cuda.launches != 1:
        raise AssertionError("d6 forward: roi_align not launched once")
    r = cfg6.result_per_im
    for k, shape in (("final_boxes", (BATCH, r, 4)), ("final_probs",
                                                      (BATCH, r)),
                     ("pooled_box_feat", (BATCH, r, 384))):
        if tuple(out6[k].shape) != shape or not torch.isfinite(
                out6[k]).all():
            raise AssertionError(f"d6 {k}: {tuple(out6[k].shape)}, want "
                                 f"{shape}, finite")
    d6 = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "detections": int(out6["final_valid"].sum()), "launches": 1}
    feats6, boxes6, levels6 = effdet_launch_inputs(model6, x6)
    d6["roi"] = check_roi_launch("effdet", "d6 P3..P7 C=384 N=100 P=7",
                                 feats6, EFFDET_STRIDES, boxes6, None, 7,
                                 timed=True, levels=levels6)
    d6["roi"]["level_counts"] = torch.bincount(
        levels6.flatten().long(), minlength=5).tolist()
    del feats6, boxes6, levels6
    d6["profile"] = phase_profile(model6, x6, "effdet-d6-profile")
    log("effdet", f"d6 forward, {sum(p.numel() for p in model6.parameters())}"
        f" params, B={BATCH} {FRAME_W}x{FRAME_H} into 1280x1280: "
        f"{d6['detections']} valid detections, roi_align launched once, "
        f"peak {d6['peak_gib']:.2f} GiB, source levels "
        f"{d6['roi']['level_counts']}")
    res["d6"] = d6
    del model6, x6, out6
    torch.cuda.empty_cache()
    return res


class MemoryBatches:
    """One training batch in memory, yielded ``steps`` times per epoch:
    DetectionTrainDataset's ``batches`` interface, for a machine with no
    cv2 and no files."""

    def __init__(self, batch, steps):
        self.batch = batch
        self.num_samples = steps * batch[0].shape[0]

    def batches(self, epochs=1):
        for _ in range(self.num_samples // self.batch[0].shape[0] * epochs):
            yield self.batch


def train_batch(cfg, max_gt, b=TRAIN_BATCH, seed=2, h=ACTEV_H, w=ACTEV_W):
    """b synthetic BGR frames (SyntheticVideo's moving rectangles, 1920x1080
    unless given another size) with their rectangles as gt: boxes padded to
    ``max_gt``, Person and Vehicle labels in turn, box-local 28x28 masks (a
    rectangle fills its box). Returns numpy (images, gt_boxes, gt_labels,
    gt_valid, gt_masks)."""
    import numpy as np
    video = SyntheticVideo(b, seed=seed, h=h, w=w)
    images = np.stack([video.read()[1] for _ in range(b)])
    ids = [cfg.classname2id["Person"], cfg.classname2id["Vehicle"]]
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    for i in range(b):
        for j, (x0, y0, vx, vy, ow, oh, _) in enumerate(video.objs):
            x = int(x0 + vx * i) % (w - ow)
            y = int(y0 + vy * i) % (h - oh)
            boxes[i, j] = (x, y, x + ow, y + oh)
            labels[i, j] = ids[j % 2]
            valid[i, j] = True
    masks = np.ones((b, max_gt, 28, 28), np.float32)
    return images, boxes, labels, valid, masks


def leaf_shares(got, ref):
    """Per parameter leaf: max |got - ref| over the leaf's max |ref|; a
    leaf that ref gives exactly zero must be zero in got (share 0 then)."""
    shares = {}
    for name, r in ref.items():
        g = got[name]
        scale = r.abs().max().item()
        if scale == 0:
            if g.abs().max().item() != 0:
                raise AssertionError(f"train f32: {name} has a gradient "
                                     f"where the plain step has none")
            shares[name] = 0.0
        else:
            shares[name] = (g - r).abs().max().item() / scale
    return shares


def phase_train(tmp):
    """The port's training entry point (cli/main.py train) at full width:
    R101-FPN v4 (the train CLI's defaults) at 1920x1080 with the mask head,
    bf16, B=2, freeze=2, random weights from seed 0 with the 0.2 BN-gamma
    scaling (through --load_from), one repeated in-memory batch at a
    constant learning rate. Then one f32 step with the trainable ROIAlign
    kernels against the plain ROIAlign's autograd on the same batch and
    draws, B1 and B1b redone on a step's own inputs, and the step's time
    split by CUDA events."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.cli import main as train_cli
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            save_npz_tree)

    device = torch.device("cuda")
    args = train_cli.get_args([
        "train", "--add_mask", "--im_batch_size", str(TRAIN_BATCH),
        "--num_step", str(TRAIN_STEPS), "--lr_schedule", "constant",
        "--warmup_steps", "0", "--clip_gradient_norm", "10",
        "--save_every", str(TRAIN_STEPS // 2), "--outbasepath",
        os.path.join(tmp, "train"), "--device", "cuda"])
    cfg = train_cli.build_config(args, True, device)
    got = (cfg.resnet_depth, cfg.use_dilations, cfg.use_frcnn_class_agnostic,
           cfg.num_class, cfg.add_mask, cfg.compute_dtype, cfg.freeze,
           cfg.roi_align_train_impl, cfg.is_train, cfg.max_size,
           cfg.short_edge_size)
    if got != (101, True, True, 16, True, "bfloat16", 2, "pallas", True,
               ACTEV_W, ACTEV_H):
        raise AssertionError(f"not the train CLI's v4 default: {got}")
    tree = init_params(cfg, seed=0)
    for gname, group in tree["resnet"].items():    # as in phase 4
        if gname.startswith("group"):
            for blk in group.values():
                last = blk["conv3"] if "conv3" in blk else blk["conv2"]
                last["bn"]["gamma"] *= 0.2
    init = os.path.join(tmp, "train_init.npz")
    save_npz_tree(init, tree)
    args.load_from = init
    batch = train_batch(cfg, args.max_gt)
    data = MemoryBatches(batch, TRAIN_STEPS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    RA.multilevel_roi_align_cuda.launches = 0
    RA.multilevel_roi_align_backward_cuda.launches = 0
    t0 = time.perf_counter()
    res = train_cli.mode_train(args, dataset=data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_n = RA.multilevel_roi_align_cuda.launches
    bwd_n = RA.multilevel_roi_align_backward_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    trainer = res["trainer"]
    model = trainer.model
    dtype = model.compute_dtype
    losses = res["losses"]
    log("train", f"main.py train: R{cfg.resnet_depth}-FPN v{args.version} + "
        f"mask head, {cfg.num_class} "
        f"classes, {ACTEV_W}x{ACTEV_H}, B={TRAIN_BATCH}, {dtype}, freeze "
        f"{cfg.freeze}, roi_align_train_impl {cfg.roi_align_train_impl}, "
        f"{res['step']} steps in {wall:.2f} s wall (build, load and "
        f"checkpoints included); total loss per step: "
        + ", ".join(f"{v:.4f}" for v in losses))
    log("train", f"launches: roi_align {fwd_n}, roi_align_backward {bwd_n} "
        f"(2 per step each); peak device memory "
        f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)")
    if res["step"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"{res['step']} steps, want {TRAIN_STEPS}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: "
                             f"{losses}")
    if fwd_n != 2 * TRAIN_STEPS or bwd_n != 2 * TRAIN_STEPS:
        raise AssertionError(f"{TRAIN_STEPS} steps launched roi_align "
                             f"{fwd_n} and roi_align_backward {bwd_n} "
                             f"times, want 2 per step each")
    ckpts = sorted(os.listdir(train_cli.checkpoint_dir(args)))
    if ckpts != sorted([f"step_{TRAIN_STEPS // 2}.pt",
                        f"step_{TRAIN_STEPS}.pt"]):
        raise AssertionError(f"checkpoints {ckpts}")
    out = {"steps": res["step"], "losses": losses, "wall_s": wall,
           "peak_gib": peak / 2 ** 30, "roi_align_launches": fwd_n,
           "roi_align_backward_launches": bwd_n}

    tb = [torch.from_numpy(x).to(device) for x in batch]
    gen = torch.Generator(device=device)

    # the step split by CUDA events
    split = {"forward+loss": [], "backward": [], "optimizer": []}
    for i in range(TRAIN_TIMED + 1):
        gen.manual_seed(1000 + i)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        step_losses = trainer.losses(*tb, generator=gen)
        ev[1].record()
        trainer.backward(step_losses)
        ev[2].record()
        trainer.apply_gradients()
        ev[3].record()
        ev[3].synchronize()
        if 0 < i:       # the first absorbs the cuDNN autotuning
            for k, (a, b) in zip(split, zip(ev, ev[1:])):
                split[k].append(a.elapsed_time(b))
    split = {k: sorted(v)[len(v) // 2] for k, v in split.items()}
    out["step_ms"] = split
    log("train", f"one bf16 step, median of {TRAIN_TIMED} (CUDA events): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f"; {sum(split.values()):.2f} ms in all")

    # B1 and B1b on a step's own inputs (the box head's N=512 P=7 and the
    # mask head's fg rows at P=14), read off its autograd graph
    gen.manual_seed(1000 + TRAIN_TIMED + 1)
    step_losses = trainer.losses(*tb, generator=gen)
    captured = roi_backward_inputs(step_losses["total_loss"])
    out["roi"], out["bwd"] = {}, {}
    for pool in sorted(captured):
        feats, boxes, strides, grad_out, levels = captured[pool]
        label = f"N={boxes.shape[1]} P={pool}"
        out["roi"][label] = check_roi_launch("train", label, feats, strides,
                                             boxes, None, pool, True)
        out["bwd"][label] = check_roi_backward(label, feats, boxes, strides,
                                               pool, grad_out, levels)
    del captured, trainer, model, res, step_losses
    torch.cuda.empty_cache()

    # one f32 step, kernel against plain, same batch and draws
    out["f32"] = train_f32_check(cfg, tree, tb)
    return out


def roi_backward_inputs(loss):
    """Runs loss's backward and returns, by pool size, the inputs that each
    trainable ROIAlign node of its graph gives B1b: (features, boxes,
    strides, grad_out, levels). The nodes are found by walking the graph
    and read by a pre-hook, which sees the gradient before the node's
    backward runs; the wrapper itself is left alone."""
    captured, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "_TrainableROIAlignBackward":
            def hook(grad_outputs, node=node):
                boxes, levels, *feats = node.saved_tensors
                captured[node.output_size] = (feats, boxes, node.strides,
                                              grad_outputs[0].contiguous(),
                                              levels)
            node.register_prehook(hook)
        todo.extend(f for f, _ in node.next_functions)
    loss.backward()
    return captured


def check_roi_backward(label, feats, boxes, strides, pool, grad_out, levels,
                       phase="train"):
    """B1b on one training launch's own inputs against autograd of the
    plain version (multilevel_roi_align_vjp). bf16 features, as on the
    bf16 path: within one bf16 step of each value plus B1B_REL of the
    level's largest magnitude (both round float32 sums that differ only in
    their order); the same launch with the features in float32 (the f32
    path's own): within B1B_REL of the level's largest magnitude. Two
    launches agree bit for bit (each
    element has one writer, adding in a fixed order). One call allocates
    nothing beyond its gradients and a small scratch, and its profile holds
    the plan and tile kernels alone, each with time. Times: the
    wrapper's CUDA-event time and the plain version's (median of 15), the
    kernels' device time (torch.profiler), the bound."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA

    def kernel(f=feats):
        return RA.multilevel_roi_align_backward_cuda(f, boxes, strides, pool,
                                                     grad_out, levels)

    def plain(f=feats):
        return RA.multilevel_roi_align_vjp(f, boxes, strides, pool, grad_out,
                                           levels)
    entry = {}
    runs = [("f32", [f.float() for f in feats])]
    if feats[0].dtype == torch.bfloat16:
        runs.insert(0, ("bf16", feats))
    for name, fs in runs:
        got, ref = kernel(fs), plain(fs)
        err = share = 0.0
        for g, r in zip(got, ref):
            g, r = g.float(), r.float()
            scale = r.abs().max().item()
            d = (g - r).abs()
            tol = B1B_REL * scale + (2.0 ** -7 * r.abs()
                                     if fs[0].dtype == torch.bfloat16 else 0)
            if not (d <= tol).all():
                raise AssertionError(f"{phase} roi_align_backward {label} "
                                     f"{name}: max |kernel - plain| "
                                     f"{d.max().item()} over its bound")
            err = max(err, d.max().item())
            share = max(share, d.max().item() / max(scale, 1e-30))
        entry[f"err_{name}"], entry[f"share_{name}"] = err, share
        again = kernel(fs)
        if not all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(got, again)):
            raise AssertionError(f"{phase} roi_align_backward {label} "
                                 f"{name}: two launches differ")
        del got, ref, again
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = kernel()
    torch.cuda.synchronize()
    entry["alloc_bytes"] = torch.cuda.max_memory_allocated() - base
    grad_bytes = sum(g.numel() * g.element_size() for g in got)
    del got
    # the gradients; the scratch (16 bytes per ROI, 4 per tile) and the
    # allocator's rounding fit in 2 MiB
    if entry["alloc_bytes"] > grad_bytes + 2 ** 21:
        raise AssertionError(f"{phase} roi_align_backward {label}: one call "
                             f"allocated {entry['alloc_bytes']} bytes for "
                             f"{grad_bytes} bytes of gradients")
    entry["ms"], entry["plain_ms"] = median_ms([kernel, plain])
    others = []
    dev = device_ms(kernel, {"plan": "roi_bwd_plan",
                             "tiles": "roi_align_bwd_tile"}, runs=15,
                    others=others)
    if others or not all(v > 0 for v in dev.values()):
        raise AssertionError(f"{phase} roi_align_backward {label}: profile "
                             f"{dev}, other device work {sorted(set(others))}")
    entry["device_ms"] = sum(dev.values())
    entry["device_by_part"] = dev
    entry["bound_ms"] = roi_bwd_bound_ms(feats, boxes, strides, pool)
    entry["bound_share"] = entry["bound_ms"] / entry["device_ms"]
    entry["design_bytes_ms"] = roi_bwd_design_ms(feats, boxes, strides, pool,
                                                 levels)
    bf16 = ("" if "err_bf16" not in entry else
            f"{entry['err_bf16']:.3g} bf16 (bound: one bf16 step + "
            f"{B1B_REL} x max |plain|), ")
    log(phase, f"roi_align_backward on the step's own inputs, {label}: max "
        f"|kernel - plain| {bf16}{entry['err_f32']:.3g} f32 "
        f"({entry['share_f32']:.3g} of max |plain|, bound {B1B_REL}); two "
        f"launches bitwise equal; one call allocates "
        f"{entry['alloc_bytes']} bytes ({grad_bytes} of gradients); "
        f"kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms "
        f"(median of 15, CUDA events), device {entry['device_ms']:.4f} ms "
        f"(torch.profiler, mean of 15: " + ", ".join(
            f"{k} {v:.4f}" for k, v in dev.items()) + f"), bound "
        f"{entry['bound_ms']:.4f} ms (bytes), {entry['bound_share']:.1%} "
        f"of it; the tiles' grad_out re-reads and the plan's scratch add "
        f"{entry['design_bytes_ms']:.4f} ms of bytes")
    return entry


def train_f32_check(cfg, tree, tb):
    """One f32 forward_train + backward (TF32 off) with the trainable
    ROIAlign kernels and with the plain ROIAlign's autograd, same weights,
    batch and draws: losses within TRAIN_LOSS_REL, every gradient leaf
    within TRAIN_GRAD_REL of its largest magnitude."""
    import torch
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import (_leaves,
                                                            params_from_jax)
    device = tb[0].device
    results = []
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, compute_dtype="float32",
                                roi_align_train_impl=impl)
        model = params_from_jax(tree, get_model(c)).to(device)
        gen = torch.Generator(device=device).manual_seed(7)
        losses = model.forward_train(*tb[:4], gt_masks=tb[4], generator=gen)
        losses["total_loss"].backward()
        grads = {"/".join(p): (t.grad if t.grad is not None
                               else torch.zeros_like(t))
                 for p, t, _ in _leaves(model)}
        results.append(({k: v.item() for k, v in losses.items()}, grads))
        del model, losses
    (lk, gk), (lp, gp) = results
    loss_rel = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp)
    if not loss_rel <= TRAIN_LOSS_REL:
        raise AssertionError(f"train f32: losses kernel {lk} vs plain {lp}")
    shares = leaf_shares(gk, gp)
    worst = max(shares, key=shares.get)
    if not shares[worst] <= TRAIN_GRAD_REL:
        raise AssertionError(f"train f32: gradient of {worst} off by "
                             f"{shares[worst]} of its max > {TRAIN_GRAD_REL}")
    vals = sorted(shares.values())
    log("train", f"f32 step, trainable ROIAlign kernels vs plain autograd: "
        f"losses within {loss_rel:.3g} (bound {TRAIN_LOSS_REL}); gradients "
        f"of {len(vals)} leaves within {vals[-1]:.3g} of each leaf's max "
        f"(worst {worst}; median {vals[len(vals) // 2]:.3g}; bound "
        f"{TRAIN_GRAD_REL})")
    torch.cuda.empty_cache()
    return {"loss_rel": loss_rel, "grad_share_max": vals[-1],
            "grad_share_median": vals[len(vals) // 2], "worst_leaf": worst,
            "losses_kernel": lk, "losses_plain": lp}


def effdet_train_setup(tmp, device):
    """The train CLI's flags with the JAX quality proof's EfficientDet
    choices (--version 2 --num_class 16, Adam at 1e-3, clip 10; here a
    constant LR, B=8, 8 steps), the config the proof builds from them
    (model="efficientdet", d0, its 512 input, score threshold 0.05), the
    model through ``build_model`` (random weights from seed 0) and a batch
    of synthetic 512x512 rectangles. Writes under ``tmp``."""
    from object_detection_tracking_tpu_torch.cli import main as train_cli
    steps = EFFDET_TRAIN_STEPS
    args = train_cli.get_args([
        "train", "--version", "2", "--num_class", "16", "--short_edge_size",
        str(EFFDET_TRAIN_SIZE), "--max_size", str(EFFDET_TRAIN_SIZE),
        "--im_batch_size", str(EFFDET_TRAIN_BATCH), "--num_step", str(steps),
        "--optimizer", "adam", "--init_lr", "1e-3", "--lr_schedule",
        "constant", "--warmup_steps", "0", "--clip_gradient_norm", "10",
        "--save_every", str(steps // 2), "--outbasepath",
        os.path.join(tmp, "effdet_train"), "--device", device.type])
    cfg = dataclasses.replace(
        train_cli.build_config(args, True, device), model="efficientdet",
        efficientdet_name=EFFDET_TRAIN,
        efficientdet_image_size=EFFDET_TRAIN_SIZE, result_score_thres=0.05)
    model = train_cli.build_model(args, cfg, device)
    got = (cfg.compute_dtype, cfg.num_class, cfg.is_train, model.name,
           model.image_size, model.backbone_name, model.fpn_filters,
           model.fpn_repeats, model.head_repeats)
    if got != ("bfloat16", 16, True, "efficientdet-d0", 512,
               "efficientnet-b0", 64, 3, 3):
        raise AssertionError(f"not the proof's d0 training setup: {got}")
    batch = train_batch(cfg, args.max_gt, b=EFFDET_TRAIN_BATCH, seed=4,
                        h=EFFDET_TRAIN_SIZE, w=EFFDET_TRAIN_SIZE)
    return args, cfg, model, batch


def train_step_profile(trainer, tb, phase):
    """Host wall of one synchronized train step (median of 5), then the
    device's kernel time over two steps under torch.profiler (after a
    profiled warm-up): the busy share of a step and its time by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step():
        trainer.backward(trainer.losses(*tb))
        trainer.apply_gradients()

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    wall = sorted(walls)[2]
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step()
            torch.cuda.synchronize()
    total, groups = kernel_kinds(prof, 2)
    n_kernels = sum(e.count for e in _cuda_events(prof)) // 2
    log(phase, f"one train step: {wall:.1f} ms host wall (median of 5, "
        f"synchronized); {total:.1f} ms of kernel time in {n_kernels} "
        f"kernel launches (torch.profiler, mean of 2), device busy "
        f"{100 * total / wall:.0f}% of the step")
    log_kernel_kinds(phase, prof, 2, groups)
    return {"wall_ms": wall, "kernel_ms": total, "busy": total / wall,
            "kernel_launches": n_kernels, "by_kind": groups}


def effdet_targets_check(model, batch):
    """effdet_anchor_targets on the card against the same call on the CPU,
    bit for bit, on the training batch's gt with, in image 0, two copies
    of its first gt (one best anchor, written twice: the later row wins)
    with the other label, a box in the top-left corner whose best anchor
    lies near anchor 0, and padded rows after them (an invalid row's best
    anchor is anchor 0, where it writes -1)."""
    import torch
    from object_detection_tracking_tpu_torch.train.targets import \
        effdet_anchor_targets
    boxes, labels, valid = (x.copy() for x in batch[1:4])
    j = int(valid[0].sum())
    if j + 3 >= boxes.shape[1]:
        raise AssertionError("no room for the duplicate gts")
    boxes[0, j:j + 2] = boxes[0, 0]
    labels[0, j:j + 2] = labels[0, 1]
    boxes[0, j + 2] = (0.0, 0.0, 20.0, 20.0)
    labels[0, j + 2] = labels[0, 0]
    valid[0, j:j + 3] = True
    anchors, _ = model._anchor_set()
    out = {}
    for dev in ("cuda", "cpu"):
        out[dev] = effdet_anchor_targets(
            anchors.to(dev), *(torch.from_numpy(x).to(dev)
                               for x in (boxes, labels, valid)))
    names = ("cls_targets", "box_targets", "fg")
    for name, a, b in zip(names, out["cuda"], out["cpu"]):
        a = a.cpu()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise AssertionError(f"effdet_anchor_targets {name}: the card's "
                                 f"differ from the CPU's")
    res = {"anchors": anchors.shape[0], "gt_rows": int(boxes.shape[1]),
           "valid_gts": int(valid.sum()), "fg": int(out["cpu"][2].sum())}
    log("effdet-train", f"effdet_anchor_targets, card vs CPU: labels, box "
        f"targets and fg equal bit for bit ({anchors.shape[0]} anchors, "
        f"B={boxes.shape[0]}, {boxes.shape[1]} gt rows, {res['valid_gts']} "
        f"valid, duplicate gts in image 0, {res['fg']} fg anchors)")
    return res


def effdet_f32_check(cfg, tree, batch):
    """One f32 forward_train + backward at B=EFFDET_F32_BATCH (TF32 off)
    on the card and on this machine's CPU, same weights and batch: losses
    within TRAIN_LOSS_REL, every gradient leaf within TRAIN_GRAD_REL of
    its largest magnitude, but the INVARIANT_LEAF ones, which must lie
    within NOISE_SHARE of the largest leaf gradient on both."""
    import torch
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import (_leaves,
                                                            params_from_jax)
    c = dataclasses.replace(cfg, compute_dtype="float32")
    results = []
    for dev in ("cuda", "cpu"):
        model = params_from_jax(tree, get_model(c)).to(dev)
        tb = [torch.from_numpy(x[:EFFDET_F32_BATCH]).to(dev)
              for x in batch[:4]]
        t0 = time.perf_counter()
        losses = model.forward_train(*tb)
        losses["total_loss"].backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        grads = {"/".join(p): (t.grad if t.grad is not None
                               else torch.zeros_like(t)).cpu()
                 for p, t, _ in _leaves(model)}
        results.append(({k: v.item() for k, v in losses.items()}, grads,
                        sec))
        del model, losses
    (lk, gk, sk), (lp, gp, sp) = results
    loss_rel = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp)
    if not loss_rel <= TRAIN_LOSS_REL:
        raise AssertionError(f"effdet f32: losses card {lk} vs CPU {lp}")
    top = max(g.abs().max().item() for g in gp.values())
    invariant = [k for k in gp if INVARIANT_LEAF.search(k)]
    noise = 0.0
    for k in invariant:
        noise = max(noise, gk.pop(k).abs().max().item() / top,
                    gp.pop(k).abs().max().item() / top)
    if not noise <= NOISE_SHARE:
        raise AssertionError(f"effdet f32: an invariant leaf's gradient is "
                             f"{noise} of the largest, > {NOISE_SHARE}")
    shares = leaf_shares(gk, gp)
    worst = max(shares, key=shares.get)
    if not shares[worst] <= TRAIN_GRAD_REL:
        raise AssertionError(f"effdet f32: gradient of {worst} off by "
                             f"{shares[worst]} of its max > {TRAIN_GRAD_REL}")
    vals = sorted(shares.values())
    log("effdet-train", f"f32 step at B={EFFDET_F32_BATCH}, card vs CPU "
        f"({sk:.2f} s vs {sp:.2f} s): losses within {loss_rel:.3g} (bound "
        f"{TRAIN_LOSS_REL}); gradients of {len(vals)} leaves within "
        f"{vals[-1]:.3g} of each leaf's max (worst {worst}; median "
        f"{vals[len(vals) // 2]:.3g}; bound {TRAIN_GRAD_REL}); "
        f"{len(invariant)} invariant leaves within {noise:.3g} of the "
        f"largest gradient (bound {NOISE_SHARE})")
    return {"loss_rel": loss_rel, "grad_share_max": vals[-1],
            "grad_share_median": vals[len(vals) // 2], "worst_leaf": worst,
            "invariant_leaves": len(invariant), "invariant_noise": noise,
            "losses_card": lk, "losses_cpu": lp}


def phase_effdet_train(tmp):
    """EfficientDet-d0 training through the train loop, its checks, the
    step's split, busy share and peak, the BN calibration, a calibrated
    inference forward, the targets and the f32 step (phase 11 of the
    module note). Returns a summary dict."""
    import contextlib
    import io
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.cli import main as train_cli
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.ops.norm import FrozenBN
    from object_detection_tracking_tpu_torch.params import (load_npz_tree,
                                                            params_to_jax)

    device = torch.device("cuda")
    steps, b = EFFDET_TRAIN_STEPS, EFFDET_TRAIN_BATCH
    args, cfg, model, batch = effdet_train_setup(tmp, device)
    n_bn = sum(isinstance(m, FrozenBN) for m in model.modules())
    n_params = sum(p.numel() for p in model.parameters())
    counters = (RA.multilevel_roi_align_cuda,
                RA.multilevel_roi_align_backward_cuda,
                RS.fused_bottleneck_stage_cuda)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        res = train_cli.train(args, cfg, model, MemoryBatches(batch, steps))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    losses = res["losses"]
    log("effdet-train", f"main.py train: {model.name} ({model.backbone_name}"
        f", BiFPN {model.fpn_filters} x{model.fpn_repeats}, heads "
        f"x{model.head_repeats}), {n_params} params, {cfg.num_class - 1} "
        f"classes, {model.image_size}x{model.image_size}, B={b}, "
        f"{cfg.compute_dtype}, Adam {args.init_lr} constant, clip "
        f"{args.clip_gradient_norm}, {args.max_gt} gt rows "
        f"({int(batch[3].sum())} valid); {res['step']} steps, calibration "
        f"and checkpoints in {wall:.2f} s wall; total loss per step: "
        + ", ".join(f"{v:.4f}" for v in losses))
    for line in printed.getvalue().splitlines():
        log("effdet-train", f"  train: {line}")
    if res["step"] != steps or len(losses) != steps:
        raise AssertionError(f"{res['step']} steps, want {steps}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: "
                             f"{losses}")
    if any(launches.values()):
        raise AssertionError(f"the EfficientDet train path launched a "
                             f"kernel: {launches}")
    if f"calibrated {n_bn} BN sites over {steps} batches" not in \
            printed.getvalue():
        raise AssertionError(f"train did not calibrate all {n_bn} BN sites")
    ckpts = sorted(os.listdir(train_cli.checkpoint_dir(args)))
    if ckpts != sorted([f"step_{steps // 2}.pt", f"step_{steps}.pt"]):
        raise AssertionError(f"checkpoints {ckpts}")
    final = load_npz_tree(os.path.join(args.outbasepath, args.modelname,
                                       "final.npz"), "efficientdet")

    def stats(node):
        if "variance" in node and not isinstance(node["variance"], dict):
            yield node["mean"], node["variance"]
        for v in node.values():
            if isinstance(v, dict):
                yield from stats(v)
    at_init = sum(bool(np.all(m == 0) or np.all(v == 1))
                  for m, v in stats(final))
    if len(list(stats(final))) != n_bn or at_init:
        raise AssertionError(f"final.npz: {at_init} of {n_bn} BN sites keep "
                             f"the init's statistics")
    out = {"steps": res["step"], "losses": losses, "wall_s": wall,
           "launches": launches, "bn_sites": n_bn, "params": n_params}

    # the step split by CUDA events, and the peak over those steps
    trainer = res["trainer"]
    tb = [torch.from_numpy(x).to(device) for x in batch[:4]]
    split = {"forward+loss": [], "backward": [], "optimizer": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_TIMED + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        step_losses = trainer.losses(*tb)
        ev[1].record()
        trainer.backward(step_losses)
        ev[2].record()
        trainer.apply_gradients()
        ev[3].record()
        ev[3].synchronize()
        if 0 < i:
            for k, (e0, e1) in zip(split, zip(ev, ev[1:])):
                split[k].append(e0.elapsed_time(e1))
    vals = {k: v.item() for k, v in step_losses.items()}
    if not all(math.isfinite(v) for v in vals.values()) or \
            not vals["num_pos_anchors"] > 0:
        raise AssertionError(f"step losses {vals}")
    out["step_ms"] = {k: sorted(v)[len(v) // 2] for k, v in split.items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["step_losses"] = vals
    log("effdet-train", f"one {cfg.compute_dtype} step at B={b}, median of "
        f"{TRAIN_TIMED} (CUDA events): " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in out["step_ms"].items())
        + f"; {sum(out['step_ms'].values()):.2f} ms in all; peak device "
        f"memory {out['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated"
        f"); losses {vals}")
    out["profile"] = train_step_profile(trainer, tb, "effdet-train")

    # calibrate_bn on the batch, from the init's statistics: every site
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBN):
                m.mean.zero_()
                m.variance.fill_(1.0)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        if model.calibrate_bn([tb[0]]) is not model:
            raise AssertionError("calibrate_bn did not return the model")
    line = printed.getvalue().strip()
    unmoved = [n for n, m in model.named_modules()
               if isinstance(m, FrozenBN) and bool(torch.all(m.variance == 1))]
    if line != f"calibrated {n_bn} BN sites over 1 batches" or unmoved:
        raise AssertionError(f"calibrate_bn: {line!r}; variance still 1 at "
                             f"{unmoved[:5]}")
    log("effdet-train", f"calibrate_bn on the batch: {line!r}; every "
        f"site's variance moved off 1")

    # a bf16 inference forward with the calibrated weights
    model.eval()
    with torch.inference_mode():
        det = model(tb[0])
    torch.cuda.synchronize()
    r = cfg.result_per_im
    for k, shape in (("final_boxes", (b, r, 4)), ("final_probs", (b, r)),
                     ("pooled_box_feat", (b, r, model.fpn_filters))):
        if tuple(det[k].shape) != shape or not torch.isfinite(det[k]).all():
            raise AssertionError(f"calibrated forward {k}: "
                                 f"{tuple(det[k].shape)}, want {shape}, "
                                 f"finite")
    out["calibrated_detections"] = int(det["final_valid"].sum())
    log("effdet-train", f"{cfg.compute_dtype} inference forward with the "
        f"calibrated weights: outputs finite, {out['calibrated_detections']} valid "
        f"detections over {b} images at score > {cfg.result_score_thres}")
    out["targets"] = effdet_targets_check(model, batch)
    tree = params_to_jax(model)
    del trainer, model, res, tb, det
    torch.cuda.empty_cache()
    out["f32"] = effdet_f32_check(cfg, tree, batch)
    return out


@contextlib.contextmanager
def cv2_blocked():
    """``import cv2`` fails, and every module of the port that bound cv2
    holds None instead, until the block ends: code that reaches cv2 raises.
    Yields whether this machine has cv2 at all."""
    import importlib.util
    present = importlib.util.find_spec("cv2") is not None
    saved = sys.modules.get("cv2")
    bound = [(m, m.cv2) for name, m in list(sys.modules.items())
             if name.startswith("object_detection_tracking_tpu_torch")
             and getattr(m, "cv2", None) is not None]
    sys.modules["cv2"] = None
    for m, _ in bound:
        m.cv2 = None
    try:
        yield present
    finally:
        for m, cv2 in bound:
            m.cv2 = cv2
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved


def quality_step_check(trainer, ds, pools=(7, 14), phase="quality"):
    """B1 and B1b on one R18 proof step's own inputs, against their plain
    versions: the proof's first batch (B=8, f32) through the trained
    model, the box head's N=512 at P=7 and (with masks) the mask head's fg
    rows at P=14, read off the step's autograd graph
    (roi_backward_inputs). Returns ({label: B1 entry}, {label: B1b
    entry})."""
    import numpy as np
    import torch
    device = trainer.model.device
    batch = next(iter(ds.batches(1)))
    tb = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
          for x in batch[:5]]
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    captured = roi_backward_inputs(
        trainer.losses(*tb, generator=gen)["total_loss"])
    if sorted(captured) != list(pools):
        raise AssertionError(f"a proof step pooled at {sorted(captured)}, "
                             f"want {list(pools)}")
    roi, bwd = {}, {}
    for pool in sorted(captured):
        feats, boxes, strides, grad_out, levels = captured[pool]
        label = (f"B={boxes.shape[0]} N={boxes.shape[1]} P={pool} "
                 f"{str(feats[0].dtype)[6:]}")
        roi[label] = check_roi_launch(phase, label, feats, strides,
                                      boxes, None, pool, True)
        bwd[label] = check_roi_backward(label, feats, boxes, strides, pool,
                                        grad_out, levels, phase=phase)
    return roi, bwd


def quality_run(tmp, name, flags, counters):
    """One cut run of the quality proof through ``quality_proof.run``, its
    checks and its summary; for R18, B1 and B1b held against their plain
    versions on a proof step's own inputs (quality_step_check)."""
    import io
    import numpy as np
    from object_detection_tracking_tpu_torch.cli import main as driver
    from object_detection_tracking_tpu_torch.cli import quality_proof as Q

    args = Q.get_args(flags + ["--workdir", os.path.join(tmp, name),
                               "--min_ap", "0", "--min_mask_iou", "0"])
    for fn in counters:
        fn.launches = 0
    # keep the proof's trainer and train set for the kernel check
    trained, real_train = {}, driver.train

    def train(train_args, cfg, model, ds, *rest, **kw):
        res = real_train(train_args, cfg, model, ds, *rest, **kw)
        trained.update(trainer=res["trainer"], ds=ds)
        return res
    printed = io.StringIO()
    driver.train = train
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            art, losses = Q.run(args)
    finally:
        driver.train = real_train
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    steps = art["trained_steps"]
    per = art["kernel_launches"]
    log("quality", f"{name}: {art['model']}, {steps} steps at B="
        f"{args.batch_size}, {art['image_size']} px, "
        f"{art['compute_dtype']} (TF32 off), {art['train_images']}+"
        f"{art['val_images']} scenes: AP@0.5 {art['ap50']}"
        + ("" if art["mask_iou"] is None else
           f", mask IOU {art['mask_iou']}")
        + f"; step {art['step_ms_median']} ms (median), {wall:.1f} s "
        f"wall; loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the "
        f"first 10 {art['train_loss']['first10']}, last 10 "
        f"{art['train_loss']['last10']}); launches: train {per['train']}"
        f", eval {per['eval']}")
    for line in printed.getvalue().splitlines():
        if line.startswith(("eval", "mean", "step ")):
            log("quality", f"  {name}: {line}")
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: {steps} steps, losses {losses}")
    third = max(1, len(losses) // 3)
    if not np.mean(losses[-third:]) < np.mean(losses[:third]):
        raise AssertionError(f"{name}: the loss did not fall: {losses}")
    if not math.isfinite(art["ap50"]) or (
            art["mask_iou"] is not None
            and not math.isfinite(art["mask_iou"])):
        raise AssertionError(f"{name}: AP {art['ap50']}, mask IOU "
                             f"{art['mask_iou']}")
    train = per["train"]
    if name == "r18-mask":
        want_train = {"multilevel_roi_align_cuda": 2 * steps,
                      "multilevel_roi_align_backward_cuda": 2 * steps,
                      "fused_bottleneck_stage_cuda": 0}
        want_eval = 3 * args.val_images
        got_eval = (per["eval"]["multilevel_roi_align_cuda"],
                    per["eval"]["mask_iou"]["multilevel_roi_align_cuda"])
        if got_eval != (want_eval, want_eval):
            raise AssertionError(f"{name}: B1 launched {got_eval} times "
                                 f"in eval, want {want_eval} each")
    else:
        want_train = {fn.__name__: 0 for fn in counters}
    if train != want_train:
        raise AssertionError(f"{name}: training launched {train}, want "
                             f"{want_train}")
    if launches["multilevel_roi_align_cuda"] != (
            train["multilevel_roi_align_cuda"]
            + per["eval"]["multilevel_roi_align_cuda"]
            + per["eval"].get("mask_iou", {}).get(
                "multilevel_roi_align_cuda", 0)):
        raise AssertionError(f"{name}: {launches} launched in all, "
                             f"the proof counted {per}")
    out = {
        "ap50": art["ap50"], "mask_iou": art["mask_iou"],
        "steps": steps, "step_ms_median": art["step_ms_median"],
        "wall_s": wall, "loss_first": losses[0],
        "loss_last": losses[-1], "launches": per}
    if name == "r18-mask":
        out["roi"], out["bwd"] = quality_step_check(**trained)
    return out


def phase_quality(tmp):
    """The port's quality proof, cut to a few steps, through its own entry
    point with cv2 blocked, and each committed artifact's freshness (phase
    12 of the module note). Returns a summary dict."""
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.utils.source_hash import \
        quality_tree_hash

    counters = (RA.multilevel_roi_align_cuda,
                RA.multilevel_roi_align_backward_cuda,
                RS.fused_bottleneck_stage_cuda)
    log("quality", "gates at 0 here: the gates belong to the committed "
        "TORCH_QUALITY_*.json artifacts")
    with cv2_blocked() as cv2_present:
        log("quality", f"cv2 {'installed' if cv2_present else 'absent'} on "
            "this machine; blocked for the proof (its import fails, the "
            "port's modules hold None for it)")
        out = {name: quality_run(tmp, name, flags, counters)
               for name, flags in QUALITY_RUNS}
    log("quality", "both runs completed with cv2 blocked")
    tree = quality_tree_hash()
    root = os.path.dirname(os.path.abspath(__file__))
    fresh = {}
    for name in QUALITY_ARTIFACTS:
        path = os.path.join(root, name)
        if not os.path.exists(path):
            fresh[name] = "missing"
        else:
            with open(path) as f:
                art = json.load(f)
            fresh[name] = ("fresh" if art["tree_hash"] == tree else
                           f"stale (made at {art['tree_hash']})")
            log("quality", f"{name}: AP@0.5 {art['ap50']}"
                + ("" if art["mask_iou"] is None else
                   f", mask IOU {art['mask_iou']}")
                + f", passed {art['passed']}, {art['trained_steps']} steps "
                f"on {art['device']}")
        log("quality", f"{name}: {fresh[name]} against tree {tree}")
    out["artifacts"] = fresh
    out["tree_hash"] = tree
    return out


def track_quality_run(tmp, tracker, counters, kept):
    """One cut run of the tracking proof through ``track_quality_proof.run``
    in the workdir ``tmp`` (the second run reuses the first one's
    detector), its checks and its summary; ``kept`` receives the
    detector's trainer and train set, the tracking model and the proof
    video."""
    import io
    from object_detection_tracking_tpu_torch.cli import main as driver
    from object_detection_tracking_tpu_torch.cli import \
        track_quality_proof as T
    from object_detection_tracking_tpu_torch.data import synthetic_np

    args = T.get_args(TRACK_QUALITY_FLAGS + [
        "--tracker", tracker, "--workdir", tmp])
    for fn in counters:
        fn.launches = 0
    real_train, real_load = driver.train, T.load_detector

    def train(train_args, cfg, model, ds, *rest, **kw):
        res = real_train(train_args, cfg, model, ds, *rest, **kw)
        kept.update(trainer=res["trainer"], ds=ds)
        return res

    def load_detector(*a):
        cfg, model, step = real_load(*a)
        kept["model"] = model
        return cfg, model, step
    real_video = synthetic_np.generate_video

    def generate_video(*a, **kw):
        kept["video"], gt = real_video(*a, **kw)
        return kept["video"], gt
    printed = io.StringIO()
    driver.train, T.load_detector = train, load_detector
    synthetic_np.generate_video = generate_video
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            art = T.run(args)
    finally:
        driver.train, T.load_detector = real_train, real_load
        synthetic_np.generate_video = real_video
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    det, per = art["detector"], art["kernel_launches"]
    # hypotheses scored: the tuned pass's, then the reference-parity pass's
    hyps = (art["fp"] + art["n_gt"] - art["fn"], int(sum(
        m["fp"] + m["n_matches"]
        for m in art["reference_parity"]["per_class"].values())))
    log("track-quality", f"{tracker}: {art['num_frames']} frames of "
        f"{args.image_size} px, {art['num_objects']} objects, hard "
        f"{art['hard']}: MOTA {art['mota']}, IDF1 {art['idf1']}, MOTP "
        f"{art['motp']}, IDSW {art['idsw']}, FP {art['fp']}, FN "
        f"{art['fn']} of {art['n_gt']}, {hyps[0]} boxes scored; reference "
        f"parity {hyps[1]} boxes scored, MOTA "
        f"{art['reference_parity']['mota']}, IDF1 "
        f"{art['reference_parity']['idf1']}; detector "
        f"{'trained here' if det['trained_here'] else 'reused'}: "
        f"{art['trained_steps']} steps at {det['step_ms_median']} ms "
        f"(median), AP@0.5 {det['ap50']}; {wall:.1f} s wall; launches: "
        f"detector {per['detector']}, tracking {per['tracking']}")
    for k in ("mota", "idf1", "motp"):
        if not math.isfinite(art[k]):
            raise AssertionError(f"{tracker}: {k} {art[k]}")
    if not sum(hyps):
        raise AssertionError(f"{tracker}: no track rows reached the score")
    steps = art["trained_steps"]
    want_train = {"multilevel_roi_align_cuda": steps,
                  "multilevel_roi_align_backward_cuda": steps,
                  "fused_bottleneck_stage_cuda": 0}
    want_eval = {"multilevel_roi_align_cuda": 2 * det["val_images"],
                 "multilevel_roi_align_backward_cuda": 0,
                 "fused_bottleneck_stage_cuda": 0}
    if per["detector"] != {"train": want_train, "eval": want_eval}:
        raise AssertionError(f"{tracker}: the detector launched "
                             f"{per['detector']}, want train {want_train}, "
                             f"eval {want_eval}")
    batches = -(-art["num_frames"] // 8)
    want_track = {"multilevel_roi_align_cuda": 2 * batches,
                  "multilevel_roi_align_backward_cuda": 0,
                  "fused_bottleneck_stage_cuda": 0}
    for name, got in per["tracking"].items():
        if got != want_track:
            raise AssertionError(f"{tracker} {name}: tracking launched "
                                 f"{got}, want {want_track}")
    want_all = {k: 2 * want_track[k] + (
        want_train[k] + want_eval[k] if det["trained_here"] else 0)
        for k in launches}
    if launches != want_all:
        raise AssertionError(f"{tracker}: {launches} launched in all, want "
                             f"{want_all}")
    return {"mota": art["mota"], "idf1": art["idf1"], "motp": art["motp"],
            "idsw": art["idsw"], "reference_parity": {
                k: art["reference_parity"][k] for k in ("mota", "idf1")},
            "trained_here": det["trained_here"], "steps": steps,
            "step_ms_median": det["step_ms_median"], "ap50": det["ap50"],
            "wall_s": wall, "launches": per}


def phase_track_quality(tmp):
    """The port's tracking proof, cut to a few steps and frames, for both
    trackers through its own entry point with cv2 blocked; B1 and B1b held
    against their plain versions on a proof step's and a tracking
    forward's own inputs; the committed artifact's freshness (phase 14 of
    the module note). Returns a summary dict."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.utils.source_hash import \
        quality_tree_hash

    counters = (RA.multilevel_roi_align_cuda,
                RA.multilevel_roi_align_backward_cuda,
                RS.fused_bottleneck_stage_cuda)
    log("track-quality", "gates at 0 here: the gates belong to the "
        "committed TORCH_TRACK_QUALITY.json")
    kept, out = {}, {}
    with cv2_blocked() as cv2_present:
        log("track-quality", f"cv2 {'installed' if cv2_present else 'absent'}"
            " on this machine; blocked for the proof")
        for tracker in ("deep_sort", "tmot"):
            out[tracker] = track_quality_run(tmp, tracker, counters, kept)
    if not out["deep_sort"]["trained_here"] or out["tmot"]["trained_here"]:
        raise AssertionError("the tmot run did not reuse the detector")
    log("track-quality", "both trackers ran with cv2 blocked")
    out["roi"], out["bwd"] = quality_step_check(
        kept["trainer"], kept["ds"], pools=(7,), phase="track-quality")
    # one tracking forward: the proof video's first batch of 8 frames
    model, video = kept["model"], kept["video"]
    video.seek(0)
    x = torch.from_numpy(np.stack([video.read()[1] for _ in range(8)])).to(
        model.device)
    with torch.inference_mode():
        fwd = model(x)
    out["track_roi"] = main_path_kernel_check(model, x, fwd,
                                              "track-quality",
                                              timed=True)["roi"]
    tree = quality_tree_hash()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "TORCH_TRACK_QUALITY.json")
    fresh = {}
    if not os.path.exists(path):
        fresh["TORCH_TRACK_QUALITY.json"] = "missing"
    else:
        with open(path) as f:
            art = json.load(f)
        for tracker in ("deep_sort", "tmot"):
            a = art[tracker]
            fresh[tracker] = ("fresh" if a["tree_hash"] == tree else
                              f"stale (made at {a['tree_hash']})")
            log("track-quality", f"TORCH_TRACK_QUALITY.json {tracker}: MOTA "
                f"{a['mota']}, IDF1 {a['idf1']}, passed {a['passed']}, "
                f"{a['trained_steps']} steps on {a['device']}: "
                f"{fresh[tracker]} against tree {tree}")
    out["artifact"] = fresh
    return out


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


def effdet_kernel_row(name, effdet, kres):
    """The kernels line's row of B1 in EfficientDet's mode (five levels,
    explicit levels) for d0 (the effdet path's launches) or d6 (its one
    forward): the path launch redone on its own inputs, and phase 3's
    synthetic case at the same shapes in f32 and bf16."""
    import torch
    launch = effdet["roi"] if name == "d0" else effdet["d6"]["roi"]
    synth = {str(dt)[6:]: dict(zip(("err", "ms", "plain_ms", "bound_ms",
                                    "device_ms"), kres[(name, dt)]))
             for dt in (torch.float32, torch.bfloat16)}
    return {
        "name": f"roi_align_5level_{name}", "route": "cuda",
        "source": "object_detection_tracking_tpu_torch/csrc/roi_align.cu",
        "replaces": "object_detection_tracking_tpu/ops/pallas/"
                    "roi_align_pallas.py:138",
        "launches": (effdet["roi_launches"] if name == "d0"
                     else effdet["d6"]["launches"]),
        "max_abs_err": max([launch["err"]]
                           + [v["err"] for v in synth.values()]),
        "ms": launch["ms"], "device_ms": launch["device_ms"],
        "plain_ms": launch["plain_ms"], "bound_ms": launch["bound_ms"],
        "bound_share": launch["bound_share"], "bound_by": "bytes",
        "library_ms": None, "level_counts": launch["level_counts"],
        "synthetic": synth,
        "shapes": ("EfficientDet-d0 path (B=8, P3..P7 of 512x512, C=64, "
                   "N=100, P=7, bf16), its launches counted over "
                   f"{N_BATCHES} batches" if name == "d0" else
                   "EfficientDet-d6 forward (B=8, P3..P7 of 1280x1280, "
                   "C=384, N=100, P=7, bf16), one launch") +
                  "; ms, device_ms, plain_ms, bound_ms: the launch redone "
                  "on its own inputs (explicit source levels, invalid "
                  "slots zero boxes on level 0); synthetic: phase 3's "
                  "case at the same shapes (random explicit levels, "
                  "P7-edge and zero boxes), f32 and bf16"}


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
    with tempfile.TemporaryDirectory() as tmp:
        tmot = phase_tmot(tmp, model, x, actev)
    del model, unfused, x
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        train = phase_train(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        effdet = phase_effdet(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        effdet_train = phase_effdet_train(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        quality = phase_quality(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        track_quality = phase_track_quality(tmp)
    tq_roi = (list(track_quality["roi"].values())
              + list(track_quality["track_roi"].values()))
    tq_launches = {t: track_quality[t]["launches"]
                   for t in ("deep_sort", "tmot")}

    roi = actev["check"]["roi"]
    four = {k: v for k, v in kres.items() if k[0] in (1000, 100)}
    err = max([r[0] for r in four.values()] + [main_res["roi_err"]]
              + [r["err"] for r in roi.values()]
              + [r["err"] for r in train["roi"].values()]
              + [r["err"] for r in quality["r18-mask"]["roi"].values()]
              + [r["err"] for r in tmot["check"]["roi"].values()]
              + [r["err"] for r in tq_roi])
    bwd = train["bwd"]
    _, k_ms, p_ms, b_ms, d_ms = kres[(1000, torch.bfloat16)]
    _, k100, p100, b100, d100 = kres[(100, torch.bfloat16)]
    bf = [sres[(name, "bfloat16")] for name, *_ in STAGES]
    stage_err = max([r["err"] for r in sres.values()]
                    + actev["check"]["stage"] + tmot["check"]["stage"])
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
        "train_launches": train["roi_align_launches"],
        "train_per_launch": train["roi"],
        "tmot_launches": tmot["roi_launches"],
        "track_quality_launches": tq_launches,
        "track_quality_per_launch": {
            "train_step": track_quality["roi"],
            "tracking_forward": track_quality["track_roi"]},
        "r50_720p": {"launches": main_res["launches"], "ms_n1000": k_ms,
                     "device_ms_n1000": d_ms, "plain_ms_n1000": p_ms,
                     "bound_ms_n1000": b_ms, "ms_n100": k100,
                     "device_ms_n100": d100, "plain_ms_n100": p100,
                     "bound_ms_n100": b100},
        "shapes": "ActEV path, one bf16 forward's own launches (B=8, "
                  "1088x1920 pyramid, C=256): N=1000 P=7, N=100 P=7, "
                  "N=100 P=14; ms (CUDA events around the wrapper), "
                  "device_ms (the kernel alone, torch.profiler), plain_ms "
                  "and bound_ms summed over them; train_launches: the "
                  "training phase's 8 steps (box head N=512 P=7, mask head "
                  "P=14, B=2), train_per_launch timed on a step's own "
                  "inputs; max_abs_err also over the R18 quality proof "
                  "step's launches (B=8, 160 px, f32; quality.r18-mask.roi)"
                  ", the TMOT pass's forward (bf16, as the ActEV forward) "
                  "and the tracking proof's train step and tracking "
                  "forward (B=8, 160 px, f32; track_quality_per_launch); "
                  "tmot_launches: phase 13's 8 batches; "
                  "track_quality_launches: phase 14's detector training "
                  "and eval and its tracking passes, by tracker"},
        {"name": "roi_align_backward", "route": "cuda",
         "source": "object_detection_tracking_tpu_torch/csrc/roi_align.cu",
         "replaces": "object_detection_tracking_tpu/ops/pallas/"
                     "roi_align_pallas.py:600",
         "launches": train["roi_align_backward_launches"],
         "max_abs_err": max(r["err_f32"] for r in list(bwd.values()) + list(
             quality["r18-mask"]["bwd"].values())
             + list(track_quality["bwd"].values())),
         "max_abs_err_bf16": max(r["err_bf16"] for r in bwd.values()),
         "ms": sum(r["ms"] for r in bwd.values()),
         "device_ms": sum(r["device_ms"] for r in bwd.values()),
         "plain_ms": sum(r["plain_ms"] for r in bwd.values()),
         "bound_ms": sum(r["bound_ms"] for r in bwd.values()),
         "bound_by": "bytes", "library_ms": None,
         "design_bytes_ms": sum(r["design_bytes_ms"] for r in bwd.values()),
         "per_launch": bwd,
         "track_quality_launches": tq_launches,
         "track_quality_per_launch": track_quality["bwd"],
         "shapes": "the training step's two launches (B=2, 1088x1920 "
                   "pyramid, C=256, bf16 features, float32 grad_out): box "
                   "head N=512 P=7, mask head fg rows P=14; max_abs_err "
                   "with the features in float32, max_abs_err_bf16 on the "
                   "path's bf16; ms, device_ms, plain_ms, bound_ms summed "
                   "over the two; bound_ms: grad_out read and the gradients "
                   "written once; design_bytes_ms: grad_out rows re-read by "
                   "each further output tile their taps reach, and the "
                   "plan's scratch, over the memory rate, the design's "
                   "overhead against bound_ms; max_abs_err also over the "
                   "R18 quality proof step's two launches (B=8, 160 px, "
                   "f32; quality.r18-mask.bwd) and the tracking proof "
                   "step's one (track_quality_per_launch)"},
        {"name": "bottleneck_stage", "route": "cuda",
         "source": "object_detection_tracking_tpu_torch/csrc/"
                   "bottleneck_stage.cu",
         "replaces": "object_detection_tracking_tpu/ops/pallas/"
                     "resnet_stage_pallas.py:155",
         "launches": actev["stage_launches"], "max_abs_err": stage_err,
         "tmot_launches": tmot["stage_launches"],
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
                   "over the three"}
        ] + [effdet_kernel_row(name, effdet, kres) for name in ("d0", "d6")],
        "effdet_path": {k: v for k, v in effdet.items()
                        if k not in ("roi", "d6")},
        "effdet_d6": {k: v for k, v in effdet["d6"].items() if k != "roi"},
        "actev_path": {k: v for k, v in actev.items() if k != "check"},
        "tmot_path": {k: v for k, v in tmot.items() if k != "check"},
        "track_quality": {k: v for k, v in track_quality.items()
                          if k not in ("roi", "bwd", "track_roi")},
        "actev_profile": prof,
        "train": {k: v for k, v in train.items() if k not in ("roi", "bwd")},
        "effdet_train": effdet_train,
        "quality": quality,
        "card": card}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
