#!/usr/bin/env python3
"""Drive the PyTorch port's video detect-and-track path and its other entry
points on one NVIDIA GPU and hold every hand-written kernel against its
plain PyTorch version.

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
               (torch.profiler) and its share of the bound; then the
               ROIAlign box-gradient kernel (B1e) against autograd of the
               plain version at synthetic shapes that reach each of its
               paths (B1E_CASES on the SO training launch's 1088x1920
               pyramid, B=2: 2000 dense p2 boxes with sub-pixel sample
               spacing, more than one wave of resident blocks; mixed sizes
               with zero-area, zero-width, wholly out-of-map and
               last-row/column boxes at P=7, 14 and 32; repeated boxes, as
               the SO classes repeat the class-agnostic boxes; C=40, a
               vector path with lanes left idle; C=36, C=30 and levels
               off 16 bytes for the scalar paths), bf16 and float32
               features, within 1e-4 of max |plain|, two launches bitwise
               equal, timed beside its bound; then greedy NMS (N1, one
               launch, its regime printed) against the plain fixpoint, keep
               masks bit for bit, at each path's NMS shape (NMS_CASES:
               proposals [8,5,1000] and, in training, [2,5,2000] at IOU
               0.7; predictions [8,15,200], small objects [8,3,1000],
               EfficientDet [8,90,200] at 0.5) on clustered boxes, timed
               beside its bound; every later phase that runs an NMS holds
               N1 the same way on its own forward's launches (7: proposals
               and predictions; 9: a train step's proposals; 10: d0's; 17:
               the small-object heads' five), and the video phases count
               its launches (2 a batch; training 1 a step)
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
 15. reid      the ReID CLIs' default extractors, osnet_x1_0 (Person) and
               resnet101 (Vehicle), seeded weights saved as torchreid .pth
               files (BN statistics measured on a seeded batch, each
               residual branch's last BN gamma x0.2), at 256x128, B=64,
               bf16: the forward's ms (median of 15 CUDA-event timings)
               and crops a second, its kernel time by kind and busy share
               (torch.profiler), peak memory, parameters, the preprocess of
               64 crops of mixed sizes and the whole call apart; card f32
               against the CPU's f32 on 16 crops (<= 1e-3 of max |CPU|,
               TF32 off), card bf16 against card f32 (row cosine >= 0.99),
               features finite; the same for one net of each further
               family (se_resnet50, resnet50_ibn_a, mobilenetv2_x1_0,
               densenet121, squeezenet1_1, shufflenet_v2_x1_0, shufflenet,
               pcb_p6, resnet50mid, mlfn, hacnn at its 160x64, mudeep,
               xception, inceptionv4, inceptionresnetv2, nasnetamobile;
               BatchNorm2d over 1x1 maps keep unit statistics, and
               inceptionv4's BN betas are 1 when its statistics are
               measured, as tests/torch_port_common.py reid_net); whether
               grid_sample (hacnn's part sampling, run in float32) takes
               bfloat16 on the card, logged; then, with
               cv2 blocked and phase 7's video
               re-rendered in memory for every decode, single_video_reid's
               main on phase 7's MOT files with each class's longest track
               cut in two (at least one candidate pair scored; the output's
               rows equal to the input's but for the ids) and
               multi_video_reid's main on two cameras sharing that video
               and those files, identical KRTD cameras (R = I, T = (0, 0,
               5)): global ids one to one, every track with features
               linked to its copy or, where the solver's cost cannot tell
               them apart (crops inside one solid rectangle give equal
               features), to a track that costs no more; B1, B1b and B2
               launched 0 times (JAX's ReID reaches no Pallas kernel)
 16. imgs      the image-list CLI (cli/obj_detect_imgs.py detect_images,
               ImageDataset batches padded to their largest image,
               DatasetEnqueuer with 2 worker threads) at its defaults:
               R101-FPN v4, --add_mask, bf16, backbone_impl="pallas", B=8,
               short edge 1080 / max 1920, phase 7's weights, 4 batches of
               seeded in-memory images (an ImageDataset subclass, no cv2)
               alternating 1920x1080 and 1440x1080; a JSON file per image,
               every output finite, B1 and B2 launched 3 times a batch;
               images/s, the host wall a batch, the forward's busy share;
               every launch of one forward held against its plain version,
               B1 timed; extract_box_feat on that batch's final boxes: one
               B1 launch, held against the plain version (timed) and
               against the forward's mean-pooled fpn_box_feat; with cv2 on
               the card, obj_detect_imgs.main on 16 PNGs written by cv2
               (logged either way); then --use_gn --use_deformable
               --add_relation_nn --use_att_frcnn_head (2 batches: B2 once
               a batch, B1 3 times, no NaN with 1000 proposal slots, ROADMAP
               C14; launches held against the plain versions; host wall and
               kernel time beside the default's), --use_conv_frcnn_head (1
               batch) and --is_efficientdet d0 (1 batch, B1 once, images
               fitted into 512)
 17. small objects  (a) the small-object heads with the person association
               (use_small_object_head, use_so_association; ROADMAP A8b) on
               phase 7's detector and weights: R101-FPN v4, masks, fused,
               bf16, B=8, 1920x1080, 3 forwards of one synthetic batch; B1
               4 times a forward (the SO and person boxes pooled in one
               launch), B2 3 times; the SO outputs' shapes, labels and
               valid counts, finite; the SO launch redone on its own inputs
               against the plain version (timed); the forward's host wall
               and kernel time with and without the heads, beside phase
               8's. (b) cli/main.py train --use_small_object_head at phase
               9's settings (B=2, masks, freeze=2, bf16), 4 steps on a
               batch of Person, Prop, Vehicle and Bike boxes: B1 and B1b 3
               times a step, B1e (the ROIAlign box gradient) once; every
               loss, so_label_loss among them, finite; the step split by
               CUDA events; B1, B1b and B1e on one step's SO launch, read
               off its autograd graph, against their plain versions
               (B1e: within 1e-4 of max |plain|, with bf16 and float32
               features; two launches bitwise equal; timed, bound)
 18. ckpt      the reference's checkpoints on the main path: phase 7's tree
               (R101-FPN v4, masks, 16 classes) written by this script as a
               TF V2 bundle under the reference's variable names (no
               resnet/ root, BN statistics under /EMA, fc6 rows C-major,
               global_step and a Momentum slot beside them) and as a
               tensorpack-named .npz of the same names; each loaded
               through the CLI's load_model with --model_path (host
               seconds and file size logged) and held equal to the tree
               bit for bit, leaf for leaf; the bundle's model driven
               through process_video (phase 7's video) with
               --log_time_and_gpu --save_util_log_to: B1 and B2 3 times a
               batch, the sampled device bytes above 0 and the series
               saved with JAX's keys, MOT rows/ids beside phase 7's; every
               launch of one forward on phase 7's batch held against the
               plain versions, and its detections matched to phase 7's
               model's (>= MATCH_MIN); a native npz with a name the model
               lacks raises KeyError; --use_lijun_video_loader raises
               RuntimeError where av does not import, and where it does,
               a video written with av is decoded through it by
               process_video
 19. parallel  data parallelism (parallel/mesh.py) on the card: the
               process group from torchrun's variables (MASTER_ADDR and
               MASTER_PORT on a free local port, RANK 0, WORLD_SIZE 1),
               NCCL, world size 1; cli/main.py train through its
               data-parallel path at phase 9's settings (R101-FPN v4,
               masks, B=2, bf16, freeze=2), 3 steps on a repeated batch,
               cuDNN deterministic; B1 and B1b 2 times a step, every loss
               finite, rank 0's checkpoints; then the same steps through
               the one-process path (the same init, batch and draws): every
               param bit for bit equal; one step's B1 and B1b launches,
               read off its autograd graph, held against their plain
               versions; the sharded step against Trainer.step by CUDA
               events (no gradient all-reduce at one data rank), and a
               flat NCCL all-reduce of the gradients apart, its result
               equal to its input; the group destroyed before the phase
               ends
 20. pack      cli/main.py pack at the CLI's defaults (R101-FPN v4, 16
               classes, 1920x1080, --add_mask, bf16, backbone "xla" as JAX's
               pack keeps it), --im_batch_size 8, phase 7's weights through
               --load_from: params.npz, config.json, forward.pt2 (the
               torch.export graph, params as inputs) and kernels/ (B1's and
               N1's libraries); a fresh process with jax and the port's
               models blocked loads it (load_packed: the kernels from the
               pack by their hashed names, no nvcc) and runs fn on phase
               7's frames, captured into one CUDA graph at its first call
               and replayed; its outputs against this process's live
               forward of the same config and weights (>= MATCH_MIN of the
               detections matched, outputs finite), B1 3 times and N1
               twice in a profiled replay (by name: the wrappers'
               counters do not tick on a replay), beside their bounds
               from the live forward's own launches; the pack's
               wall, the fresh process's load and first-call seconds, the
               replay's ms a batch beside the live forward's, the phase's
               own wall
Then one JSON line of kernels, the card line, and the last line:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The script imports nothing of JAX: the port must run without it.
"""

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import re
import shutil
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
# torch.profiler: profiles taken before one without device time is given up
PROFILE_TRIES = 4
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
# ReID phase (15): the CLIs' default extractors (--p_reid_model_name,
# --v_reid_model_name), their crop size and the extractor's default batch
REID_MODELS = (("Person", "osnet_x1_0"), ("Vehicle", "resnet101"))
REID_SIZE, REID_BATCH = (256, 128), 64
# card f32 (TF32 off) against the CPU's f32, as a share of max |CPU|: the
# same float32 products summed in other orders, over ~100 convs; card bf16
# against card f32: the least cosine of a crop's two feature rows
REID_F32_REL, REID_COS_MIN, REID_CHECK_CROPS = 1e-3, 0.99, 16
# f32 forward, ROIAlign kernel vs plain: share of the plain run's
# detections matched by the kernel run (same label, box within 0.5 px).
# Sums ~1e-6 apart can swap two detections' ranks; only a swap across the
# top-100 cut-off changes the set, at most a detection or two per image.
MATCH_MIN = 0.98
# image-list phase (16): the image CLI's sizes, mixed so that each batch
# is padded to its largest image (1920x1080 beside 4:3 1440x1080), the
# batches of the default path and of the options, the PNGs of the real
# CLI run (when cv2 is on the card)
IMG_SIZES = ((1080, 1920), (1080, 1440))
IMG_BATCHES, IMG_OPT_BATCHES, IMG_PNGS = 4, 2, 16
IMG_OPTIONS = ["--use_gn", "--use_deformable", "--add_relation_nn",
               "--use_att_frcnn_head"]
# ReID phase (15), extended: one net of each further family, as the
# defaults are run
REID_FAMILIES = ("se_resnet50", "resnet50_ibn_a", "mobilenetv2_x1_0",
                 "densenet121", "squeezenet1_1", "shufflenet_v2_x1_0",
                 "shufflenet", "pcb_p6", "resnet50mid", "mlfn", "hacnn",
                 "mudeep", "xception", "inceptionv4", "inceptionresnetv2",
                 "nasnetamobile")
# deep BN-ReLU stacks without a residual: every BatchNorm2d's beta is 1
# before the statistics are measured (with beta 0 a random Inception-v4 is
# chaotic, its float32 forward 7e-4 of max from float64 at 256x128 on the
# CPU; tests/torch_port_common.py reid_net)
REID_PLAIN = ("inceptionv4",)
# small-object phase (17): the SO heads on phase 7's detector, timed
# forwards; the train CLI with --use_small_object_head at phase 9's
# settings, steps; B1e vs plain autograd, as a share of max |plain|
# (float32 sums over the samples and channels of each ROI, in another
# fixed order; tests/test_torch_kernels_cuda.py)
SO_FORWARDS, SO_TRAIN_STEPS = 3, 4
B1E_REL = 1e-4
# B1e's synthetic cases (phase 3) on the SO training launch's padded image
# (B=TRAIN_BATCH): (label, kind of boxes, boxes per image, pool, channels,
# levels off 16 bytes); box_grad_case says what each kind holds
B1E_H, B1E_W = 1088, 1920
B1E_CASES = (
    ("dense p2 2x1000 P=7 C=256", "dense", 1000, 7, 256, False),
    ("mixed 2x300 P=7 C=256", "mixed", 300, 7, 256, False),
    ("mixed 2x64 P=14 C=256", "mixed", 64, 14, 256, False),
    ("mixed 2x16 P=32 C=256", "mixed", 16, 32, 256, False),
    ("repeat 2x300 P=7 C=256", "repeat", 300, 7, 256, False),
    ("mixed 2x100 P=7 C=40", "mixed", 100, 7, 40, False),
    ("mixed 2x100 P=7 C=36", "mixed", 100, 7, 36, False),
    ("mixed 2x100 P=7 C=30", "mixed", 100, 7, 30, False),
    ("mixed 2x100 P=7 C=256 off16", "mixed", 100, 7, 256, True),
)
# the image boxes that open every "mixed" case: a zero box (no sample in
# the map), zero width, wholly outside the image on either side, the whole
# image (p5), a corner, and zero-area and zero-height/width boxes whose
# samples lie exactly on p2's last row and column (iy = 271, ix = 479)
B1E_EDGE_BOXES = (
    (0.0, 0.0, 0.0, 0.0), (50.0, 20.0, 50.0, 90.0),
    (2000.0, 1200.0, 2100.0, 1300.0), (-300.0, -200.0, -10.0, -20.0),
    (0.0, 0.0, 1920.0, 1088.0), (1700.0, 900.0, 1920.0, 1088.0),
    (1918.0, 1086.0, 1918.0, 1086.0), (20.0, 1086.0, 200.0, 1086.0),
    (1918.0, 10.0, 1918.0, 150.0),
)
# reference-checkpoint phase (18): --log_time_and_gpu's sampling period
# there (the CLI's 5 s would see no sample in a drive of a few seconds),
# and the frames that phase decodes with PyAV where av imports
CKPT_PERF_INTERVAL = 0.25
CKPT_PYAV_FRAMES = 16
# data-parallel phase (19): steps through main.py train's sharded path and
# through its one-process path; the timed step pairs
PAR_STEPS, PAR_TIMED = 3, 5
# greedy NMS (N1), phase 3's synthetic cases at each path's NMS shape
# [groups..., N] and threshold: the proposals at test (image, level) and
# in training, the predictions (image, class; 15 classes at 2R), the
# small-object heads (image, SO class) and EfficientDet (image, class)
NMS_CASES = (
    ("proposals", (BATCH, 5, 1000), 0.7),
    ("train proposals", (TRAIN_BATCH, 5, 2000), 0.7),
    ("predictions", (BATCH, 15, 200), 0.5),
    ("small objects", (BATCH, 3, 1000), 0.5),
    ("effdet", (BATCH, 90, 200), 0.5),
)
# float32 operations of one IOU test in pairwise_iou's order (2 min, 2 max,
# 2 subtractions, 2 clamps, the intersection's product, the union's add
# and subtraction, the division, the comparison), and of one box's area
NMS_PAIR_OPS, NMS_BOX_OPS = 13, 3
# N1's one kernel, by the name the profiler records
NMS_KERNEL = "nms_keep_kernel"


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


def box_grad_case(gen, kind, n, c, dtype, off16=False, device="cuda"):
    """B1e's synthetic inputs on the 1088x1920 pyramid (p2..p5, B=
    TRAIN_BATCH, unit-normal features and grad_out): "dense", n boxes an
    image of 8-40 px a side (aspect 1/1.4..1.4) inside the image, all on p2
    at a sample spacing under 1 px, so neighbouring bins share most taps;
    "mixed", B1E_EDGE_BOXES then boxes of 16-600 px a side (aspect 1/3..3)
    centred anywhere in the image or 10% around it; "repeat", boxes of
    that size repeated, as the SO heads' classes repeat the class-agnostic
    boxes: n // 3 boxes three times each in a random order, nine copies of
    the first. ``off16``: each level
    a view one element past 16 bytes. Returns (features, boxes [B, n, 4],
    grad_out [B, n, P, P, C] for P from the caller: a function of P)."""
    import torch
    b = TRAIN_BATCH
    feats = [torch.randn(b, B1E_H >> i, B1E_W >> i, c, device=device,
                         generator=gen).to(dtype) for i in range(2, 6)]
    if off16:
        views = []
        for f in feats:
            buf = torch.empty(f.numel() + 1, dtype=dtype, device=device)
            view = buf[1:].view(f.shape)
            view.copy_(f)
            views.append(view)
        feats = views

    def uniform(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, device=device,
                                           generator=gen)
    if kind == "dense":
        side = torch.exp(uniform(math.log(8.0), math.log(40.0), (b, n)))
        ar = torch.exp(uniform(-math.log(1.4), math.log(1.4), (b, n)))
        bw, bh = side * ar.sqrt(), side / ar.sqrt()
        x0 = uniform(0.0, 1.0, (b, n)) * (B1E_W - bw)
        y0 = uniform(0.0, 1.0, (b, n)) * (B1E_H - bh)
    else:
        side = torch.exp(uniform(math.log(16.0), math.log(600.0), (b, n)))
        ar = torch.exp(uniform(-math.log(3.0), math.log(3.0), (b, n)))
        bw, bh = side * ar.sqrt(), side / ar.sqrt()
        x0 = uniform(-0.1 * B1E_W, 1.1 * B1E_W, (b, n)) - bw / 2
        y0 = uniform(-0.1 * B1E_H, 1.1 * B1E_H, (b, n)) - bh / 2
    boxes = torch.stack([x0, y0, x0 + bw, y0 + bh], -1)
    if kind == "mixed":
        edge = torch.tensor(B1E_EDGE_BOXES, device=device)
        boxes[:, :len(edge)] = edge[:n]
    elif kind == "repeat":
        # each image's boxes drawn from n // 3 of them, each three times in
        # a random order, the first nine one box
        pick = torch.arange(n, device=device) % (n // 3)
        pick = pick[torch.randperm(n, device=device, generator=gen)]
        pick[:9] = 0
        boxes = boxes[:, pick]
    boxes = boxes.contiguous()

    def grad_out(pool):
        return torch.randn(b, n, pool, pool, c, device=device,
                           generator=gen)
    return feats, boxes, grad_out


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


def nms_case(gen, shape):
    """N1's synthetic inputs at a path's NMS shape: boxes [*shape, 4]
    float32 in a 1920x1080 frame, clustered as proposals and detections
    are (a box size a cluster, each box's centre and size jittered by about
    10% of it, eight boxes a cluster on average), ~20% invalid."""
    import torch
    dev = "cuda"
    n = shape[-1]
    k = max(1, n // 8)
    lead = tuple(shape[:-1])

    def uniform(lo, hi, size):
        return lo + (hi - lo) * torch.rand(size, device=dev, generator=gen)
    centres = uniform(0.0, 1.0, lead + (k, 2)) * torch.tensor(
        [ACTEV_W, ACTEV_H], device=dev)
    sizes = torch.exp(uniform(math.log(8.0), math.log(400.0), lead + (k, 2)))
    pick = torch.randint(0, k, tuple(shape) + (1,), device=dev,
                         generator=gen).expand(*shape, 2)
    wh = torch.gather(sizes, -2, pick) * torch.exp(
        0.1 * torch.randn(tuple(shape) + (2,), device=dev, generator=gen))
    c = torch.gather(centres, -2, pick) + 0.1 * wh * torch.randn(
        tuple(shape) + (2,), device=dev, generator=gen)
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1).contiguous()
    valid = torch.rand(tuple(shape), device=dev, generator=gen) > 0.2
    return boxes, valid


def nms_bound_ms(boxes, valid, keep):
    """N1's least time on this card for these inputs: the boxes and
    validity read once and the keep mask written once, over the memory
    rate; against NMS_PAIR_OPS float32 operations for each (kept box,
    later valid box) pair, the tests greedy NMS needs on this data, and
    NMS_BOX_OPS a box, over the float32 rate. Returns (ms, "bytes" or
    "operations")."""
    later = valid.flip(-1).long().cumsum(-1).flip(-1) - valid.long()
    pairs = int((keep.long() * later).sum().item())
    nbytes = boxes.numel() * 4 + 2 * valid.numel()
    ops = NMS_PAIR_OPS * pairs + NMS_BOX_OPS * valid.numel()
    t_bytes, t_ops = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def nms_regime(valid):
    """N1's launch for keep masks of ``valid``'s shape (ops/nms.py
    greedy_keep_plan): cluster size, CTAs, threads and shared bytes a
    CTA, and its text."""
    import math
    from object_detection_tracking_tpu_torch.ops import nms as N
    plan = N.greedy_keep_plan(math.prod(valid.shape[:-1]), valid.shape[-1],
                              valid.device)
    text = (f"cluster of {plan['cluster']} CTAs a group" if plan["cluster"]
            > 1 else "one CTA a group")
    return plan, (f"{text}, {plan['ctas']} CTAs of {plan['threads']} "
                  f"threads, {plan['smem']} shared bytes each")


def check_nms(phase, label, boxes, valid, thres, timed=True):
    """One N1 launch (the keep mask of score-sorted boxes) redone on its
    inputs through the kernel and the plain fixpoint: bit for bit equal.
    With ``timed``: median CUDA-event times of the wrapper's call and of
    the plain version, the kernel's own device time (torch.profiler, its
    one launch), and the bound. Returns a dict."""
    from object_detection_tracking_tpu_torch.ops import nms as N

    def kernel():
        return N.greedy_keep_cuda(boxes, valid, thres)

    def plain():
        return N.greedy_keep_plain(boxes, valid, thres)
    got = kernel()
    ref = plain()
    diff = int((got != ref).sum().item())
    if diff:
        raise AssertionError(f"{phase} nms {label}: {diff} keep flags "
                             f"differ from the plain fixpoint's")
    entry = {"err": float(diff), "shape": list(valid.shape),
             "valid": int(valid.sum().item()), "kept": int(ref.sum().item())}
    entry["regime"], regime = nms_regime(valid)
    msg = ""
    if timed:
        entry["ms"], entry["plain_ms"] = median_ms([kernel, plain])
        entry["device_ms"] = device_ms(kernel, {"keep": NMS_KERNEL},
                                       runs=15)["keep"]
        entry["bound_ms"], entry["bound_by"] = nms_bound_ms(boxes, valid,
                                                            ref)
        entry["bound_share"] = entry["bound_ms"] / entry["device_ms"]
        msg = (f"; kernel {entry['ms']:.4f} ms, plain "
               f"{entry['plain_ms']:.4f} ms (median of 15, CUDA events), "
               f"kernel device {entry['device_ms']:.4f} ms (one launch; "
               f"torch.profiler, mean of 15), bound {entry['bound_ms']:.4f} "
               f"ms ({entry['bound_by']}), {entry['bound_share']:.1%} of it")
    log(phase, f"nms (N1) {label} {entry['shape']}, IOU > {thres} "
        f"({regime}): {entry['kept']} of {entry['valid']} valid kept, keep "
        f"masks equal to the plain fixpoint's bit for bit{msg}")
    return entry


def record_nms(fn):
    """Runs fn with N1's wrapper recording the inputs of each of its calls
    (cloned): returns (fn's result, [(boxes, valid, thres)])."""
    from object_detection_tracking_tpu_torch.ops import nms as N
    real = N.greedy_keep_cuda
    seen = []

    def recording(boxes, valid, thres):
        seen.append((boxes.clone(), valid.clone(), thres))
        return real(boxes, valid, thres)
    # the wrapper counts its launches on the module's name, which is
    # ``recording`` meanwhile
    recording.launches = real.launches
    N.greedy_keep_cuda = recording
    try:
        out = fn()
    finally:
        N.greedy_keep_cuda = real
        real.launches = recording.launches
    return out, seen


def check_nms_launches(phase, seen, labels):
    """``check_nms`` (timed) on each recorded launch, by label."""
    if len(seen) != len(labels):
        raise AssertionError(f"{phase}: {len(seen)} NMS launches, want "
                             f"{len(labels)} ({labels})")
    return {label: check_nms(phase, label, *launch)
            for label, launch in zip(labels, seen)}


def phase_nms_kernels():
    """N1 against the plain fixpoint at each path's NMS shape on clustered
    synthetic boxes (NMS_CASES), timed."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    return {label: check_nms("kernels", label, *nms_case(gen, shape), thres)
            for label, shape, thres in NMS_CASES}


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
    from object_detection_tracking_tpu_torch.ops import nms as N
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
    N.greedy_keep_cuda.launches = 0
    t0 = time.perf_counter()
    frames = cli.process_video(args, cfg, runner, "synthetic.mp4",
                               cfg.classid2name, coco_to_actev,
                               vcap=SyntheticVideo(n_frames))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = RA.multilevel_roi_align_cuda.launches
    nms_n = N.greedy_keep_cuda.launches
    if frames != n_frames // FRAME_GAP or runner.batches != N_BATCHES:
        raise AssertionError(f"{frames} frames in {runner.batches} batches")
    if launches != 2 * runner.batches or nms_n != 2 * runner.batches:
        raise AssertionError(f"roi_align launched {launches} and nms {nms_n}"
                             f" times for {runner.batches} batches, want 2 "
                             f"per batch each")
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
            "nms_launches": nms_n, "track_rows": rows}
    names = {i: n for n, i in cfg.classname2id.items()}
    by_name = {names[k]: v for k, v in sorted(runner.by_label.items())}
    log("main", f"{frames} frames (1/{FRAME_GAP} of {n_frames}) in "
        f"{runner.batches} batches of {BATCH}: {wall:.3f} s wall, "
        f"{main['fps']:.2f} processed fps, {main['ms_per_batch']:.1f} ms per "
        f"batch (decode + device + Deep SORT, pipelined), "
        f"{main['dets_per_frame']:.1f} detections/frame, roi_align launches "
        f"{launches}, nms {nms_n} (2 per batch each), detections by class "
        f"{by_name}, MOT "
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
    prof = must_profile(lambda: model(x), 2, phase)
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
             "pool" if "pool" in k else
             "conv (cuDNN)" if any(t in k for t in (
                 "fprop", "conv", "xmma", "cutlass", "implicit", "dgrad",
                 "wgrad", "nchw", "nhwc")) else
             # cuBLAS's Hopper kernels (nvjet) run the 1x1 convs as GEMMs
             "gemm" if any(t in k for t in ("gemm", "sm90_xmma",
                                            "nvjet")) else
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


def profiled(fn, runs, names=(), warmup=1):
    """torch.profiler over ``runs`` calls of fn, after a profiled warm-up
    of ``warmup`` calls, which absorbs the tracer's start-up. CUPTI now
    and then hands
    back a profile with no device activity, or without a kernel that ran:
    the profile is taken again, up to PROFILE_TRIES times in all, until it
    holds device time and, for each substring in ``names``, a kernel whose
    name holds it. Returns the profile, or None if no try gave one."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        for n in (warmup, runs):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        timed = [e.key for e in _cuda_events(prof)
                 if e.self_device_time_total > 0]
        if timed and all(any(name in k for k in timed) for name in names):
            return prof
    return None


def must_profile(fn, runs, phase):
    """``profiled`` with a warm-up of ``runs`` calls, for a time by kernel
    kind, which CUDA events cannot give: raises if no try recorded device
    time. A train step changes the weights that later checks read, so the
    calls it makes on a first try are the same in every run."""
    prof = profiled(fn, runs, warmup=runs)
    if prof is None:
        raise AssertionError(f"{phase}: torch.profiler recorded no device "
                             f"time in {PROFILE_TRIES} tries")
    return prof


def event_ms(fn, runs):
    """Device time per call of ``runs`` calls of fn queued back to back
    between two CUDA events, after a warm-up call: the time the stream
    takes for them, an upper bound on their kernels' own time."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def device_ms(fn, names, runs=3, others=None, per_call=None):
    """Device time per call of fn's kernels whose names hold each of
    ``names`` ({group: substring}): torch.profiler over `runs` calls
    (``profiled``), each group's time over the launches the profile
    recorded of it, times the launches one call makes (``per_call``,
    {group: n}, 1 where not given). A profile late in a long run once
    held 1 of 15 launches, which a mean over the calls would have read as
    a fifteenth of the time; the log says where launches are missing.
    Only the kernels' own time: no host preamble, no allocation. Returns
    {group: ms}; the names of the other device activities (kernels,
    memsets, copies) with time are appended to ``others`` when given.
    Where no profile holds every group, one group is timed with CUDA
    events instead (``event_ms``) and the log says so; several groups
    cannot be told apart that way, and raise."""
    prof = profiled(fn, runs, tuple(names.values()))
    if prof is None:
        if len(names) != 1:
            raise AssertionError(f"torch.profiler recorded none of "
                                 f"{sorted(names.values())} in "
                                 f"{PROFILE_TRIES} tries")
        ms = event_ms(fn, runs)
        log("profile", f"torch.profiler recorded no {list(names.values())} "
            f"kernel in {PROFILE_TRIES} tries: {ms:.4f} ms from CUDA events "
            f"around {runs} calls back to back instead")
        return dict.fromkeys(names, ms)
    total = dict.fromkeys(names, 0.0)
    count = dict.fromkeys(names, 0)
    for e in _cuda_events(prof):
        hit = False
        for group, name in names.items():
            if name in e.key:
                total[group] += e.self_device_time_total / 1e3
                count[group] += e.count
                hit = True
        if not hit and others is not None and e.self_device_time_total > 0:
            others.append(e.key)
    out = {}
    for group in names:
        n = (per_call or {}).get(group, 1)
        if count[group] != n * runs:
            log("profile", f"{names[group]}: the profile recorded "
                f"{count[group]} of {n * runs} launches; its time is over "
                f"those it recorded")
        out[group] = total[group] / count[group] * n
    return out


def roi_device_ms(fn):
    """Device time per call of fn's one ROIAlign kernel launch
    (torch.profiler over 15 calls)."""
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
                # a launch each conv: 3 a block, the first's shortcut
                for kind, ms in device_ms(kernel, {
                        "1x1": "bneck_conv1x1",
                        "3x3": "bneck_conv3x3"}, per_call={
                        "1x1": 2 * n + (c_in != 4 * width),
                        "3x3": n}).items():
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
    from object_detection_tracking_tpu_torch.ops import nms as N
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.runtime import DetectionRunner

    runner = CheckedRunner(DetectionRunner(model), cfg.result_per_im,
                           cfg.num_class, masks=True)
    n_frames = FRAME_GAP * BATCH * N_BATCHES
    RA.multilevel_roi_align_cuda.launches = 0
    RS.fused_bottleneck_stage_cuda.launches = 0
    N.greedy_keep_cuda.launches = 0
    t0 = time.perf_counter()
    frames = cli.process_video(args, cfg, runner, name + ".mp4",
                               cfg.classid2name, None,
                               vcap=SyntheticVideo(n_frames, h=ACTEV_H,
                                                   w=ACTEV_W))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    roi_n = RA.multilevel_roi_align_cuda.launches
    stage_n = RS.fused_bottleneck_stage_cuda.launches
    runner.nms_launches = N.greedy_keep_cuda.launches
    if frames != n_frames // FRAME_GAP or runner.batches != N_BATCHES:
        raise AssertionError(f"{frames} frames in {runner.batches} batches")
    if roi_n != 3 * runner.batches or stage_n != 3 * runner.batches:
        raise AssertionError(
            f"{runner.batches} batches launched roi_align {roi_n} and the "
            f"bottleneck stage {stage_n} times, want 3 per batch each")
    if runner.nms_launches != 2 * runner.batches:
        raise AssertionError(f"{runner.batches} batches launched nms "
                             f"{runner.nms_launches} times, want 2 per "
                             f"batch (proposals, predictions)")
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
           "nms_launches": runner.nms_launches,
           "dets_per_frame": runner.dets / frames, "track_rows": rows,
           "runner_ms": 1e3 * runner.runner_s / runner.batches,
           "caller_ms": 1e3 * runner.consumer_s / runner.batches}
    log("actev", f"{frames} frames (1/{FRAME_GAP} of {n_frames}) of "
        f"{ACTEV_W}x{ACTEV_H} in {runner.batches} batches of {BATCH}: "
        f"{wall:.3f} s wall, {res['fps']:.2f} processed fps, "
        f"{res['ms_per_batch']:.1f} ms per batch, masks [{BATCH},"
        f"{cfg.result_per_im},28,28] in [0,1] every batch, {res['dets_per_frame']:.1f} detections/frame, "
        f"launches: roi_align {roi_n}, bottleneck stage {stage_n} (3 per "
        f"batch each), nms {runner.nms_launches} (2 per batch), detections "
        f"by class {by_name}, MOT rows/ids {rows}")
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
        out, seen = record_nms(lambda: model(x))
    res["check"] = main_path_kernel_check(model, x, out, "actev", timed=True)
    res["nms"] = check_nms_launches("actev", seen,
                                    ["proposals", "predictions"])
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
    with torch.inference_mode():
        _, seen = record_nms(lambda: model(x))
    res["nms"] = check_nms_launches("effdet", seen, ["effdet"])
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
    from object_detection_tracking_tpu_torch.ops import nms as N
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
    N.greedy_keep_cuda.launches = 0
    t0 = time.perf_counter()
    res = train_cli.mode_train(args, dataset=data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_n = RA.multilevel_roi_align_cuda.launches
    bwd_n = RA.multilevel_roi_align_backward_cuda.launches
    nms_n = N.greedy_keep_cuda.launches
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
        f"(2 per step each), nms {nms_n} (1 per step); peak device memory "
        f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)")
    if res["step"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"{res['step']} steps, want {TRAIN_STEPS}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"a loss is not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: "
                             f"{losses}")
    if fwd_n != 2 * TRAIN_STEPS or bwd_n != 2 * TRAIN_STEPS \
            or nms_n != TRAIN_STEPS:
        raise AssertionError(f"{TRAIN_STEPS} steps launched roi_align "
                             f"{fwd_n}, roi_align_backward {bwd_n} and nms "
                             f"{nms_n} times, want 2, 2 and 1 per step")
    ckpts = sorted(os.listdir(train_cli.checkpoint_dir(args)))
    if ckpts != sorted([f"step_{TRAIN_STEPS // 2}.pt",
                        f"step_{TRAIN_STEPS}.pt"]):
        raise AssertionError(f"checkpoints {ckpts}")
    out = {"steps": res["step"], "losses": losses, "wall_s": wall,
           "peak_gib": peak / 2 ** 30, "roi_align_launches": fwd_n,
           "roi_align_backward_launches": bwd_n, "nms_launches": nms_n}

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
    step_losses, seen = record_nms(lambda: trainer.losses(*tb, generator=gen))
    out["nms"] = check_nms_launches("train", seen, ["train proposals"])
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


def roi_backward_inputs(loss, key=lambda node: node.output_size):
    """Runs loss's backward and returns, by ``key`` of the node (its pool
    size unless given), the inputs that each trainable ROIAlign node of its
    graph gives B1b (and B1e): (features, boxes, strides, grad_out,
    levels). The nodes are found by walking the graph and read by a
    pre-hook, which sees the gradient before the node's backward runs; the
    wrapper itself is left alone."""
    captured, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "_TrainableROIAlignBackward":
            def hook(grad_outputs, node=node):
                boxes, levels, *feats = node.saved_tensors
                captured[key(node)] = (feats, boxes, node.strides,
                                       grad_outputs[0].contiguous(), levels)
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
    prof = must_profile(step, 2, phase)
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


def reid_weights(name, path, seed):
    """Seeded weights of ReID net ``name`` saved as a torchreid ``.pth`` at
    ``path``, as tests/torch_port_common.py ``reid_net`` makes them at
    small size: torchreid's init from ``seed``, each residual branch's last
    BN gamma (OSBlockINin's IN gamma) x0.2, then every BatchNorm2d's
    running statistics measured on the card over a seeded batch of
    REID_BATCH normal images at the net's input size (REID_SIZE, or its
    fixed one); the fc head's BN1d and a BatchNorm2d over 1x1 maps keep
    unit statistics, and the nets of REID_PLAIN have every BatchNorm2d's
    beta at 1 before the measure. With the init's unit statistics a random
    OSNet's features barely depend on the input and every crop would look
    alike. Returns the parameter count."""
    import torch
    from torch import nn
    from object_detection_tracking_tpu_torch.models.reid import (
        ibn_reid, mlfn_reid, mobilenetv2, osnet, resnet_reid, senet_reid)
    from object_detection_tracking_tpu_torch.models.reid.extractor import (
        FIXED_IMAGE_SIZE, build_reid_model)
    torch.manual_seed(seed)
    net = build_reid_model(name).cuda()
    bns = []
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (resnet_reid.Bottleneck, senet_reid.SEBottleneck,
                              ibn_reid.IBNBottleneck)):
                m.bn3.weight.mul_(0.2)
            elif isinstance(m, mlfn_reid.MLFNBlock):
                m.fm_bn3.weight.mul_(0.2)
            elif isinstance(m, mobilenetv2.MobileBottleneck) \
                    and m.use_residual:
                m.conv3[1].weight.mul_(0.2)
            elif isinstance(m, resnet_reid.BasicBlock):
                m.bn2.weight.mul_(0.2)
            elif isinstance(m, (osnet.OSBlock, osnet.OSBlockAIN)):
                last = m.conv3.bn if m.conv3.bn is not None else m.IN
                last.weight.mul_(0.2)
            if isinstance(m, nn.BatchNorm2d):
                m.momentum = None     # running stats = this batch's
                m.reset_running_stats()
                if name in REID_PLAIN:
                    m.bias.fill_(1.0)
                bns.append(m)
        gen = torch.Generator("cuda").manual_seed(seed + 1)
        x = torch.randn(REID_BATCH, 3, *FIXED_IMAGE_SIZE.get(name, REID_SIZE),
                        device="cuda", generator=gen)
        net.train()
        for m in net.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.eval()
        pointwise = set()
        hooks = [m.register_forward_hook(
            lambda m, inp, out: pointwise.add(m)
            if inp[0].shape[2:].numel() == 1 else None) for m in bns]
        net(x)
        for h in hooks:
            h.remove()
    for m in bns:
        m.momentum = 0.1
        if m in pointwise:
            m.reset_running_stats()
    torch.save({k: v.cpu() for k, v in net.state_dict().items()}, path)
    return sum(p.numel() for p in net.parameters())


def reid_crops(n, seed):
    """n BGR crops of 24-360 x 48-720 px cut from a 1920x1080 frame of the
    synthetic video at random places (mixed sizes: every one resized)."""
    import numpy as np
    frame = SyntheticVideo(1, seed=seed, h=ACTEV_H, w=ACTEV_W).read()[1]
    rng = np.random.RandomState(seed)
    crops = []
    for _ in range(n):
        w, h = rng.randint(24, 361), rng.randint(48, 721)
        x, y = rng.randint(0, ACTEV_W - w), rng.randint(0, ACTEV_H - h)
        crops.append(frame[y:y + h, x:x + w].copy())
    return crops


def reid_extractor_run(name, path, crops):
    """Phase 15's timing and checks of one extractor at REID_BATCH crops
    (module note): the bf16 forward's CUDA-event ms, its host wall, kernel
    time by kind and busy share, peak memory, the preprocess and the whole
    call apart; card f32 against the CPU's f32 on REID_CHECK_CROPS crops;
    card bf16 against card f32, row by row."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.models.reid.extractor import \
        FeatureExtractor

    ex = FeatureExtractor(name, path)          # the CLIs': bf16 on the card
    if ex.dtype != torch.bfloat16 or ex.device.type != "cuda":
        raise AssertionError(f"{name}: {ex.dtype} on {ex.device}")

    def host_ms(fn, reps):
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        return sorted(walls)[reps // 2]

    with torch.inference_mode():
        xb = ex.preprocess(crops).to(ex.dtype).permute(0, 3, 1, 2)

        def forward():
            return ex.model(xb)
        ms = median_ms([forward])[0]
        wall = host_ms(forward, 5)
        pre_ms = host_ms(lambda: ex.preprocess(crops), 15)
        call_ms = host_ms(lambda: ex(crops), 5)
        prof = must_profile(forward, 2, "reid")
        total, groups = kernel_kinds(prof, 2)
        n_kernels = sum(e.count for e in _cuda_events(prof)) // 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        forward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in ex.model.parameters())
    log("reid", f"{name}: {n_params} params, bf16, B={len(crops)} at "
        f"{ex.image_size[0]}x{ex.image_size[1]}: forward {ms:.3f} ms (median "
        f"of 15 "
        f"CUDA-event timings), {1e3 * len(crops) / ms:.0f} crops/s; host "
        f"wall {wall:.2f} ms, {total:.3f} ms of kernels in {n_kernels} "
        f"launches (torch.profiler, mean of 2), device busy "
        f"{100 * total / wall:.0f}%; peak {peak:.2f} GiB; preprocess of "
        f"{len(crops)} crops of mixed sizes {pre_ms:.2f} ms, the whole call "
        f"(preprocess, forward, features to the host) {call_ms:.2f} ms")
    log_kernel_kinds("reid", prof, 2, groups)

    # card f32 (TF32 off) against the CPU's f32 on the same crops, and the
    # card's bf16 against its f32
    sub = crops[:REID_CHECK_CROPS]
    f32 = FeatureExtractor(name, path, compute_dtype="float32")
    cpu = FeatureExtractor(name, path, compute_dtype="float32",
                           device="cpu")
    got, ref = f32(sub), cpu(sub)
    bf, full = ex(crops), f32(crops)
    for label, v in (("bf16", bf), ("f32", full), ("cpu f32", ref)):
        if not np.isfinite(v).all():
            raise AssertionError(f"{name}: {label} features not finite")
    if not (bf.shape == full.shape == (len(crops), ex.model.feature_dim)
            and ref.shape == got.shape == (len(sub), ex.model.feature_dim)):
        raise AssertionError(f"{name}: shapes {bf.shape} {ref.shape}")
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    cos = (bf * full).sum(1) / np.maximum(
        np.linalg.norm(bf, axis=1) * np.linalg.norm(full, axis=1), 1e-30)
    log("reid", f"{name}: card f32 vs CPU f32 on {len(sub)} crops: max |d| "
        f"{rel:.3g} of max |CPU| (bound {REID_F32_REL}); card bf16 vs f32 "
        f"on {len(crops)}: least row cosine {cos.min():.5f} (bound "
        f"{REID_COS_MIN}); features finite")
    if not rel <= REID_F32_REL:
        raise AssertionError(f"{name}: card f32 vs CPU {rel} > "
                             f"{REID_F32_REL}")
    if not cos.min() >= REID_COS_MIN:
        raise AssertionError(f"{name}: bf16 vs f32 cosine {cos.min()} < "
                             f"{REID_COS_MIN}")
    del ex, f32, cpu
    torch.cuda.empty_cache()
    return {"params": n_params, "ms": ms, "crops_per_s": 1e3 * len(crops) / ms,
            "wall_ms": wall, "kernel_ms": total, "busy": total / wall,
            "kernel_launches": n_kernels, "by_kind": groups,
            "peak_gib": peak, "preprocess_ms": pre_ms, "call_ms": call_ms,
            "f32_rel": rel, "bf16_min_cos": float(cos.min())}


def _mot_rows(path):
    """A MOT file's rows as lists of fields (strings)."""
    with open(path) as f:
        return [ln.strip().split(",") for ln in f if ln.strip()]


def _write_mot(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.writelines(",".join(r) + "\n" for r in rows)


def reid_single(tmp, tracks, models):
    """single_video_reid's main on phase 7's MOT files with each class's
    longest track cut in two (one row dropped, the second half renumbered):
    the pairs scored, the cut pair's distance, and the output's rows equal
    to the input's in all but the id column (module note)."""
    from object_detection_tracking_tpu_torch.cli import single_video_reid \
        as SV
    from object_detection_tracking_tpu_torch.reid import single_video as sv

    cut = {}
    for cls, _ in REID_MODELS:
        rows = _mot_rows(os.path.join(tracks, "actev", cls, "actev.txt"))
        ids = [int(r[1]) for r in rows]
        if rows:
            tid = max(set(ids), key=ids.count)
            mine = sorted((r for r in rows if int(r[1]) == tid),
                          key=lambda r: int(r[0]))
            mid = len(mine) // 2
            new = max(ids) + 1
            drop = mine[mid]
            rows = [r for r in rows if r is not drop]
            for r in mine[mid + 1:]:
                r[1] = str(new)
            cut[cls] = (tid, new, len(mine))
        _write_mot(os.path.join(tmp, "tracks", "actev", cls, "actev.txt"),
                   rows)
    with open(os.path.join(tmp, "videos.lst"), "w") as f:
        f.write("actev.mp4\n")
    scored = []
    real = sv.compute_candidate_distances

    def candidate_distances(*a, **kw):
        out = real(*a, **kw)
        scored.append({q: [(e[0], e[-1]) for e in v] for q, v in out.items()})
        return out
    sv.compute_candidate_distances = candidate_distances
    t0 = time.perf_counter()
    try:
        SV.main(["--video_dir", tmp, "--video_lst_file",
                 os.path.join(tmp, "videos.lst"), "--track_dir",
                 os.path.join(tmp, "tracks"), "--out_dir",
                 os.path.join(tmp, "out"), "--person_reid_model",
                 models["Person"], "--vehicle_reid_model",
                 models["Vehicle"]])
    finally:
        sv.compute_candidate_distances = real
    wall = time.perf_counter() - t0
    pairs = [(q, g, d) for run in scored for q, v in run.items()
             for g, d in v]
    if not pairs:
        raise AssertionError(f"single_video_reid scored no candidate pair "
                             f"(cut tracks {cut})")
    out = {"wall_s": wall, "pairs": len(pairs), "cut": {}}
    for cls, _ in REID_MODELS:
        src = _mot_rows(os.path.join(tmp, "tracks", "actev", cls,
                                     "actev.txt"))
        path = os.path.join(tmp, "out", "actev", cls, "actev.txt")
        got = _mot_rows(path) if src else []

        def key(r):
            return tuple(float(v) for i, v in enumerate(r[:7]) if i != 1)
        if sorted(map(key, got)) != sorted(map(key, src)):
            raise AssertionError(f"single_video_reid {cls}: output rows "
                                 "differ from the input's beyond the ids")
        if cls in cut:
            tid, new, n = cut[cls]
            dist = [d for q, g, d in pairs if q == tid and g == new]
            merged = new not in {int(r[1]) for r in got}
            out["cut"][cls] = {"track": tid, "rows": n, "dist": dist,
                               "merged": merged}
            log("reid", f"single_video_reid {cls}: track {tid} ({n} rows) "
                f"cut into {tid} and {new}; the pair's distance "
                f"{dist} (reject at 200), merged back: {merged}")
        else:
            log("reid", f"single_video_reid {cls}: no tracks in phase 7's "
                "MOT file")
    log("reid", f"single_video_reid: {len(pairs)} candidate pairs scored, "
        f"{wall:.2f} s wall; output rows equal to the input's but for ids")
    return out


def reid_multi(tmp, tracks, models):
    """multi_video_reid's main on two cameras that share phase 7's video
    and MOT files, with identical KRTD cameras (R = I, T = (0, 0, 5): the
    cross-camera homography is the identity): the global ids must be one
    to one, and every track with features must share its global id with
    its copy, or with a track that the solver's cost cannot tell from the
    copy: the synthetic objects are solid rectangles, so two tracks' crops
    inside one rectangle are equal images with equal features, and both
    cost 0 (module note)."""
    import numpy as np
    from object_detection_tracking_tpu_torch.cli import multi_video_reid \
        as MV

    cams = ("cam1", "cam2")
    krtd = (f"1000 0 {ACTEV_W / 2}\n0 1000 {ACTEV_H / 2}\n0 0 1\n\n"
            "1 0 0\n0 1 0\n0 0 1\n\n0 0 5\n\n0\n")
    for cam in cams:
        with open(os.path.join(tmp, f"{cam}.krtd"), "w") as f:
            f.write(krtd)
        for cls, _ in REID_MODELS:
            _write_mot(os.path.join(tmp, "tracks", cam, cls, f"{cam}.txt"),
                       _mot_rows(os.path.join(tracks, "actev", cls,
                                              "actev.txt")))
    with open(os.path.join(tmp, "cameras.json"), "w") as f:
        json.dump({"reference_camera": "cam1", "videos": {
            cam: {"video": f"{cam}.mp4", "camera_file": f"{cam}.krtd",
                  "frame_offset": 0} for cam in cams}}, f)
    feats = {}
    real = MV.extract_track_features

    def extract_track_features(track_data, video_path, ex, *a):
        out = real(track_data, video_path, ex, *a)
        feats[os.path.basename(video_path), ex.model_name] = out
        return out
    MV.extract_track_features = extract_track_features
    t0 = time.perf_counter()
    try:
        MV.main(["--camera_config", os.path.join(tmp, "cameras.json"),
                 "--video_dir", tmp, "--track_dir",
                 os.path.join(tmp, "tracks"), "--out_dir",
                 os.path.join(tmp, "out"), "--person_reid_model",
                 models["Person"], "--vehicle_reid_model",
                 models["Vehicle"]])
    finally:
        MV.extract_track_features = real
    wall = time.perf_counter() - t0
    out = {"wall_s": wall}
    for cls, name in REID_MODELS:
        f1, f2 = feats[("cam1.mp4", name)], feats[("cam2.mp4", name)]
        gids = {}
        for cam in cams:
            path = os.path.join(tmp, "out", cam, cls, f"{cam}.txt")
            gids[cam] = ({int(r[1]): int(r[7]) for r in _mot_rows(path)}
                         if os.path.exists(path) else {})

        def cost(t, u):
            """The solver's cost of (t, u): compute_feature_dist's min
            squared distance, clamped at 0, in the same float32 steps."""
            a, b = f1[t], f2[u]
            return float(np.maximum(
                np.square(a).sum(1)[:, None] + np.square(b).sum(1)[None]
                - 2.0 * a @ b.T, 0).min())
        # each track's partner in the other camera: its global id's other
        # member (one each way, or the ids are not one to one)
        members = {}
        for cam in cams:
            for t, g in gids[cam].items():
                members.setdefault(g, {}).setdefault(cam, []).append(t)
        copies, ties, bad = [], [], []
        for t in f1:
            m = members.get(gids["cam1"].get(t, -1), {})
            u = m.get("cam2", [None])
            if (gids["cam1"].get(t, -1) == -1 or len(u) != 1
                    or len(m.get("cam1", [])) != 1 or u[0] not in f2):
                bad.append((t, m))
            elif u[0] == t:
                copies.append(t)
            elif cost(t, u[0]) <= cost(t, t):
                ties.append((t, u[0], cost(t, t)))
            else:
                bad.append((t, u[0], cost(t, t), cost(t, u[0])))
        if bad or set(f1) != set(f2):
            raise AssertionError(f"multi_video_reid {cls}: tracks not "
                                 f"linked to their copies: {bad}")
        copy = max((cost(t, t) for t in f1), default=None)
        other = min((cost(t, u) for t in f1 for u in f2 if u != t),
                    default=None)
        out[cls] = {"tracks": len(f1), "global_ids": len(
            set(gids["cam1"].values()) - {-1}), "copies": len(copies),
            "ties": [t[:2] for t in ties], "max_copy_cost": copy,
            "min_other_cost": other}
        log("reid", f"multi_video_reid {cls}: {len(f1)} tracks with "
            f"features in each camera, {out[cls]['global_ids']} global ids "
            f"one to one; {len(copies)} linked to their copies, "
            f"{len(ties)} to another track at a tie (the solver's cost to "
            f"it no more than to the copy: {ties}); squared feature "
            f"distance to the copy at most {copy}, to any other track at "
            f"least {other} (clamped at 0, as compute_feature_dist does)")
    log("reid", f"multi_video_reid: {wall:.2f} s wall")
    return out


def memory_images(n, batch_size, sizes=None, orig=None, seed=0):
    """The image CLI's dataset over ``n`` seeded in-memory BGR images
    (SyntheticVideo frames) already at their target ``sizes``, as read
    from originals of ``orig`` sizes: an ``ImageDataset`` whose
    get_sample makes the image instead of reading and resizing a file (no
    cv2). The sizes alternate, so ImageDataset.collect_batch pads each
    batch to its largest image."""
    from object_detection_tracking_tpu_torch.data import ImageDataset
    orig = orig or IMG_SIZES
    sizes = sizes or orig

    class MemoryImages(ImageDataset):
        def get_sample(self, idx):
            k = idx % len(sizes)
            (h, w), (oh, ow) = sizes[k], orig[k]
            return {"img": SyntheticVideo(1, seed=seed + idx, h=h,
                                          w=w).read()[1],
                    "img_name": self.img_paths[idx], "img_path": None,
                    "scale": (h / oh + w / ow) / 2.0, "orig_hw": (oh, ow)}

    ds = MemoryImages([f"mem{i:03d}.png" for i in range(n)], 0, 0,
                      batch_size=batch_size)
    ds.sizes = sizes
    return ds


class FiniteRunner:
    """Wraps DetectionRunner.run: fails on any non-finite float output and
    counts batches, images, valid detections and the time spent inside
    the runner."""

    def __init__(self, runner):
        self.runner = runner
        self.batches = self.images = self.dets = 0
        self.runner_s = 0.0

    def run(self, batches):
        import numpy as np
        it = self.runner.run(batches)
        while True:
            t0 = time.perf_counter()
            try:
                host, meta = next(it)
            except StopIteration:
                return
            self.runner_s += time.perf_counter() - t0
            for k, v in host.items():
                if v.dtype == np.float32 and not np.isfinite(v).all():
                    raise AssertionError(f"{k} is not finite")
            self.batches += 1
            self.images += len(meta["img_names"])
            self.dets += int(host["final_valid"].sum())
            yield host, meta


def imgs_args(out_dir, *extra):
    """The image CLI's arguments at its defaults (R101-FPN v4, 1080/1920)
    with B=8 and two worker threads, and ``extra`` flags."""
    from object_detection_tracking_tpu_torch.cli import obj_detect_imgs
    return obj_detect_imgs.get_args([
        "--img_lst", "none", "--out_dir", out_dir, "--short_edge_size",
        str(ACTEV_H), "--max_size", str(ACTEV_W), "--im_batch_size",
        str(BATCH), "--num_cpu_worker", "2", "--prefetch", "3", *extra])


def imgs_tree(cfg, seed=0):
    """Phase 7's weights (actev_setup) for ``cfg``: each residual branch's
    last BN gamma x0.2 and +1 on the Person and Vehicle logits; each
    deformable offset conv redrawn so that its taps move by about a pixel
    (the init's stddev of 1e-8 would leave them on the grid)."""
    import numpy as np
    from object_detection_tracking_tpu_torch.params import init_params
    tree = init_params(cfg, seed=seed)
    rng = np.random.RandomState(seed + 1)
    for gname, group in tree["resnet"].items():
        if gname.startswith("group"):
            for blk in group.values():
                blk["conv3"]["bn"]["gamma"] *= 0.2
                if "conv2_offset" in blk:
                    wo = blk["conv2_offset"]["W"]
                    std = 0.5 / math.sqrt(wo.shape[0] * wo.shape[1]
                                          * wo.shape[2])
                    blk["conv2_offset"]["W"] = (
                        rng.randn(*wo.shape) * std).astype(np.float32)
    bias = tree["fastrcnn"]["outputs"]["class"]["b"]
    for name in ("Person", "Vehicle"):
        bias[cfg.classname2id[name]] += 1.0
    return tree


def drive_imgs(phase, args, cfg, model, dataset, out_dir, roi_per_batch,
               stage_per_batch):
    """``dataset`` through the image CLI's detect_images with ``model``,
    the launch counts set to 0 just before and read just after; fails
    unless every image has its JSON file, every output is finite and B1
    and B2 launched ``roi_per_batch`` and ``stage_per_batch`` times a
    batch. Returns a summary dict."""
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_imgs
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.runtime import DetectionRunner

    runner = FiniteRunner(DetectionRunner(model))
    RA.multilevel_roi_align_cuda.launches = 0
    RS.fused_bottleneck_stage_cuda.launches = 0
    t0 = time.perf_counter()
    n = obj_detect_imgs.detect_images(args, cfg, runner, dataset, out_dir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    roi_n = RA.multilevel_roi_align_cuda.launches
    stage_n = RS.fused_bottleneck_stage_cuda.launches
    files = sorted(os.listdir(out_dir))
    want = sorted(f"mem{i:03d}.json" for i in range(dataset.num_samples))
    if n != dataset.num_samples or files != want:
        raise AssertionError(f"{phase}: {n} images, {len(files)} JSON files"
                             f" for {dataset.num_samples} images")
    nb = runner.batches
    if roi_n != roi_per_batch * nb or stage_n != stage_per_batch * nb:
        raise AssertionError(
            f"{phase}: {nb} batches launched roi_align {roi_n} and the "
            f"bottleneck stage {stage_n} times, want {roi_per_batch} and "
            f"{stage_per_batch} per batch")
    boxes = 0
    for name in files:
        with open(os.path.join(out_dir, name)) as f:
            for det in json.load(f):
                if not all(math.isfinite(v)
                           for v in det["bbox"] + [det["score"]]):
                    raise AssertionError(f"{phase}: {name}: {det}")
                boxes += 1
    res = {"images": n, "batches": nb, "wall_s": wall,
           "images_per_s": n / wall, "ms_per_batch": 1e3 * wall / nb,
           "runner_ms_per_batch": 1e3 * runner.runner_s / nb,
           "roi_launches": roi_n, "stage_launches": stage_n,
           "dets_per_image": runner.dets / n, "json_dets": boxes}
    log(phase, f"{n} images ({' and '.join(f'{w}x{h}' for h, w in dataset.sizes)}"
        f" alternating) in {nb} batches of {dataset.batch_size} through "
        f"detect_images (DatasetEnqueuer, 2 worker threads): {wall:.3f} s "
        f"wall, {res['images_per_s']:.2f} images/s, "
        f"{res['ms_per_batch']:.1f} ms host wall a batch "
        f"({res['runner_ms_per_batch']:.1f} in DetectionRunner.run), "
        f"{res['dets_per_image']:.1f} detections/image, {boxes} written, "
        f"all finite; launches: roi_align {roi_n}, bottleneck stage "
        f"{stage_n} ({roi_per_batch} and {stage_per_batch} per batch)")
    return res


def first_batch(dataset):
    """The dataset's first batch as the CLI pads it, on the card."""
    import torch
    batch = dataset.collect_batch([dataset.get_sample(i)
                                   for i in range(dataset.batch_size)])
    return torch.from_numpy(batch["imgs"]).cuda()


def phase_imgs(tmp):
    """The image-list CLI (phase 16 of the module note)."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_imgs
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.params import save_npz_tree

    device = torch.device("cuda")
    res = {}
    # (a) the image CLI's default path
    args = imgs_args(os.path.join(tmp, "json"), "--add_mask")
    cfg = dataclasses.replace(obj_detect_imgs.build_config(args, device),
                              backbone_impl="pallas")
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking
    actev_cfg = dataclasses.replace(obj_detect_tracking.build_config(
        actev_args(tmp, tmp), device), backbone_impl="pallas")
    if dataclasses.asdict(cfg) != dataclasses.asdict(actev_cfg):
        raise AssertionError("the image CLI's default configuration is not "
                             "the video CLI's (phase 7)")
    tree = imgs_tree(cfg)
    model = build_model(cfg, tree, device)
    ds = memory_images(IMG_BATCHES * BATCH, BATCH)
    t0 = time.perf_counter()
    x = first_batch(ds)
    make_ms = 1e3 * (time.perf_counter() - t0)
    model(x)                                     # cuDNN / allocator warm-up
    torch.cuda.synchronize()
    res["default"] = drive_imgs("imgs", args, cfg, model, ds, args.out_dir,
                                3, 3)
    res["default"]["make_batch_ms"] = make_ms
    log("imgs", f"the data plane alone: {make_ms:.1f} ms of host wall to "
        f"make one batch in this thread ({BATCH} get_sample calls, "
        "collect_batch's padding, the H2D copy)")
    with torch.inference_mode():
        out = model(x)
    res["check"] = main_path_kernel_check(model, x, out, "imgs", timed=True)
    res["profile"] = phase_profile(model, x, "imgs-profile")

    # (c) extract_box_feat on (a)'s model, on x and x's own final boxes
    boxes = out["final_boxes"].contiguous()
    RA.multilevel_roi_align_cuda.launches = 0
    feat = model.extract_box_feat(x, boxes)
    torch.cuda.synchronize()
    n_ebf = RA.multilevel_roi_align_cuda.launches
    if n_ebf != 1:
        raise AssertionError(f"extract_box_feat launched roi_align {n_ebf} "
                             "times, want 1")
    hp, wp, _, _ = model._static_geometry(*x.shape[1:3])
    with torch.inference_mode():
        feats = list(model.backbone(model.preprocess(x, hp, wp))[:4])
    ebf = check_roi_launch("imgs", "extract_box_feat N=%d P=7"
                           % boxes.shape[1], feats,
                           cfg.anchor_strides[:4], boxes, None, 7,
                           timed=True)
    del feats
    valid = out["final_valid"]
    ref = out["fpn_box_feat"].mean(dim=(2, 3))
    err = (feat - ref)[valid].abs().max().item()
    bound = KERNEL_ATOL * max(1.0, ref[valid].abs().max().item())
    if not err <= bound:
        raise AssertionError(f"extract_box_feat vs the forward's box "
                             f"features: {err} > {bound}")
    ebf.update(launches=n_ebf, vs_forward=err)
    res["extract_box_feat"] = ebf
    log("imgs", f"extract_box_feat on the batch's own {int(valid.sum())} "
        f"valid final boxes of {boxes.shape[0] * boxes.shape[1]}: 1 "
        f"roi_align launch, max |extract - forward's mean-pooled "
        f"fpn_box_feat| {err:.3g} over the valid slots (bound {bound:.3g})")

    # (d) the real CLI on PNGs, when cv2 is on the card
    if importlib.util.find_spec("cv2") is None:
        res["cli"] = "cv2 absent"
        log("imgs", "cv2 is not importable on this machine: the CLI's "
            "main on PNG files did not run (detect_images ran above)")
    else:
        import cv2
        src = memory_images(IMG_PNGS, BATCH)
        paths = []
        for i in range(IMG_PNGS):
            path = os.path.join(tmp, f"png{i:02d}.png")
            cv2.imwrite(path, src.get_sample(i)["img"])
            paths.append(path)
        with open(os.path.join(tmp, "imgs.lst"), "w") as f:
            f.write("\n".join(paths) + "\n")
        save_npz_tree(os.path.join(tmp, "r101.npz"), tree)
        out_dir = os.path.join(tmp, "cli_json")
        t0 = time.perf_counter()
        n = obj_detect_imgs.main([
            "--img_lst", os.path.join(tmp, "imgs.lst"), "--out_dir",
            out_dir, "--model_path", os.path.join(tmp, "r101.npz"),
            "--add_mask", "--im_batch_size", str(BATCH), "--num_cpu_worker",
            "2", "--device", "cuda"])
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(out_dir))
        if n != IMG_PNGS or files != [f"png{i:02d}.json"
                                      for i in range(IMG_PNGS)]:
            raise AssertionError(f"obj_detect_imgs.main: {n} images, "
                                 f"{len(files)} JSON files")
        res["cli"] = {"images": n, "wall_s": wall}
        log("imgs", f"cv2 present: obj_detect_imgs.main on {n} PNGs "
            f"(cv2.imread, --model_path npz, R101 built anew): {wall:.2f} s "
            "wall, a JSON file per image")
    del model, out, x, feat, ref
    torch.cuda.empty_cache()

    # (b) the options at full width
    args = imgs_args(os.path.join(tmp, "json_opt"), "--add_mask",
                     *IMG_OPTIONS)
    cfg = dataclasses.replace(obj_detect_imgs.build_config(args, device),
                              backbone_impl="pallas")
    if not (cfg.use_gn and cfg.use_deformable and cfg.add_relation_nn
            and cfg.use_att_frcnn_head):
        raise AssertionError(f"options not in the configuration: {cfg}")
    model = build_model(cfg, imgs_tree(cfg), device)
    ds = memory_images(IMG_OPT_BATCHES * BATCH, BATCH, seed=100)
    x = first_batch(ds)
    model(x)
    torch.cuda.synchronize()
    log("imgs-options", f"{' '.join(IMG_OPTIONS)}: fused groups "
        f"{model.resnet.fused_groups} (deformable groups run unfused)")
    res["options"] = drive_imgs("imgs-options", args, cfg, model, ds,
                                args.out_dir, 3, 1)
    with torch.inference_mode():
        out = model(x)
    n_pad = int((~out["final_valid"]).sum())
    for k, v in out.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"options forward: {k} has NaN or inf")
    res["options_check"] = main_path_kernel_check(model, x, out,
                                                  "imgs-options")
    res["options_profile"] = phase_profile(model, x, "imgs-options-profile")
    log("imgs-options", f"every output finite with "
        f"{cfg.rpn_test_post_nms_topk} proposal slots an image "
        f"({n_pad} of {out['final_valid'].numel()} final slots invalid; "
        f"ROADMAP C14); forward host wall "
        f"{res['options_profile']['wall_ms']:.1f} ms against "
        f"{res['profile']['wall_ms']:.1f} ms for (a), kernel time "
        f"{res['options_profile']['kernel_ms']:.1f} against "
        f"{res['profile']['kernel_ms']:.1f} ms")
    del model, out, x
    torch.cuda.empty_cache()

    # the conv box head, one batch
    args = imgs_args(os.path.join(tmp, "json_conv"), "--add_mask",
                     "--use_conv_frcnn_head")
    cfg = dataclasses.replace(obj_detect_imgs.build_config(args, device),
                              backbone_impl="pallas")
    model = build_model(cfg, imgs_tree(cfg), device)
    ds = memory_images(BATCH, BATCH, seed=200)
    model(first_batch(ds))                       # warm-up
    res["conv_head"] = drive_imgs("imgs-conv-head", args, cfg, model, ds,
                                  args.out_dir, 3, 3)
    del model
    torch.cuda.empty_cache()

    # EfficientDet-d0, one batch, fitted into its 512 input
    args = imgs_args(os.path.join(tmp, "json_effdet"), "--is_efficientdet",
                     "--efficientdet_modelname", "efficientdet-d0",
                     "--use_partial_classes")
    cfg = obj_detect_imgs.build_config(args, device)
    _, ecfg, etree = effdet_setup(tmp, device, "efficientdet-d0", EFFDET_H,
                                  EFFDET_W)
    if dataclasses.asdict(cfg) != dataclasses.asdict(ecfg):
        raise AssertionError("the image CLI's EfficientDet configuration is "
                             "not the video CLI's (phase 10)")
    model = build_model(cfg, etree, device, "efficientdet")
    fitted = tuple((round(h * 512 / max(h, w)), round(w * 512 / max(h, w)))
                   for h, w in IMG_SIZES)
    ds = memory_images(BATCH, BATCH, sizes=fitted, seed=300)
    model(first_batch(ds))                       # warm-up
    res["effdet"] = drive_imgs("imgs-effdet", args, cfg, model, ds,
                               args.out_dir, 1, 0)
    del model
    torch.cuda.empty_cache()
    return res


def grid_sample_bf16():
    """Whether F.grid_sample takes bfloat16 input and grid on the card, and
    how far its output is then from float32's (hacnn samples its parts in
    float32 either way: a bfloat16 grid keeps 8 bits of each coordinate)."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator("cuda").manual_seed(7)
    x = torch.randn(8, 32, 80, 32, device="cuda", generator=gen)
    theta = torch.tensor([[1.0, 0.0, 0.1], [0.0, 0.25, -0.4]],
                         device="cuda").expand(8, 2, 3)
    grid = F.affine_grid(theta, list(x.shape), align_corners=False)
    ref = F.grid_sample(x, grid, align_corners=False)
    try:
        got = F.grid_sample(x.bfloat16(), grid.bfloat16(),
                            align_corners=False).float()
    except RuntimeError as e:
        log("reid", f"grid_sample in bfloat16 on the card raises: {e}")
        return {"runs": False}
    rel = float((got - ref).abs().max() / ref.abs().max())
    log("reid", f"grid_sample in bfloat16 on the card runs; max |d| from "
        f"float32 {rel:.3g} of max |f32| (hacnn samples in float32)")
    return {"runs": True, "rel_err": rel}


def phase_reid(tmp, tracks):
    """ReID at the CLIs' defaults (phase 15 of the module note): seeded
    osnet_x1_0 and resnet101 checkpoints, each extractor timed and checked
    at REID_BATCH crops, then single_video_reid and multi_video_reid
    through their own main on phase 7's MOT files (``tracks``) and video,
    the decode swapped for frames from memory and cv2 blocked; B1, B1b
    and B2 must launch 0 times. Returns a summary dict."""
    import torch
    from object_detection_tracking_tpu_torch.cli import single_video_reid \
        as SV
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA

    counters = (RA.multilevel_roi_align_cuda,
                RA.multilevel_roi_align_backward_cuda,
                RS.fused_bottleneck_stage_cuda)
    for fn in counters:
        fn.launches = 0
    models, res = {}, {}
    crops = reid_crops(REID_BATCH, seed=4)
    for i, (cls, name) in enumerate(REID_MODELS):
        models[cls] = os.path.join(tmp, f"{name}.pth")
        reid_weights(name, models[cls], seed=i)
        res[name] = reid_extractor_run(name, models[cls], crops)
    for i, name in enumerate(REID_FAMILIES, start=len(REID_MODELS)):
        path = os.path.join(tmp, f"{name}.pth")
        reid_weights(name, path, seed=i)
        res[name] = reid_extractor_run(name, path, crops)
    res["grid_sample_bf16"] = grid_sample_bf16()
    n_frames = FRAME_GAP * BATCH * N_BATCHES
    opened = []

    def open_video(path, decoder="auto"):
        opened.append(os.path.basename(path))
        return SyntheticVideo(n_frames, h=ACTEV_H, w=ACTEV_W)
    real_open = SV.open_video
    SV.open_video = open_video
    try:
        with cv2_blocked() as cv2_present:
            log("reid", f"cv2 {'installed' if cv2_present else 'absent'} on "
                "this machine; blocked for the CLIs; phase 7's video "
                "re-rendered in memory for every decode")
            os.makedirs(os.path.join(tmp, "single"))
            os.makedirs(os.path.join(tmp, "multi"))
            res["single_video_reid"] = reid_single(
                os.path.join(tmp, "single"), tracks, models)
            res["multi_video_reid"] = reid_multi(
                os.path.join(tmp, "multi"), tracks, models)
    finally:
        SV.open_video = real_open
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    res.update(launches=launches, decodes=opened)
    log("reid", f"kernel launches on the ReID path: {launches} (want 0: "
        f"JAX's ReID reaches no pl.pallas_call); video decodes {opened}")
    if any(launches.values()):
        raise AssertionError(f"the ReID path launched {launches}")
    return res


def roi_box_grad_bound_ms(feats, boxes, strides, pool, levels):
    """The least time of one B1e launch, the larger of its bytes and its
    operations, for what this launch's boxes need: the grad_out rows of
    the bins with an in-map sample read once (float32), the feature pixels
    the in-map taps read (roi_touched_bytes), the boxes and levels read and
    4 floats a ROI written, over the memory rate; 16 float32 operations a
    channel for each in-map sample (its two bilinear mixes along each axis,
    their differences, two multiply-adds), over the float32 peak. Returns
    (ms, "bytes" or "operations")."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    b, n = boxes.shape[:2]
    c = feats[0].shape[-1]
    dev = boxes.device
    lvl = levels.long().clamp(0, len(feats) - 1)
    stride = torch.tensor(list(strides), dtype=torch.float32, device=dev)
    fb = boxes / stride[lvl][..., None]

    def inside(lo, hi, extents):
        ext = torch.tensor(extents, device=dev)[lvl][..., None]
        s = RA._sample_grid(lo, hi, 2 * pool)
        return (s >= 0) & (s <= (ext - 1).float())           # [B, N, 2P]
    yin = inside(fb[..., 1], fb[..., 3], [f.shape[1] for f in feats])
    xin = inside(fb[..., 0], fb[..., 2], [f.shape[2] for f in feats])
    samples = int((yin.sum(-1) * xin.sum(-1)).sum().item())
    bins = int((yin.reshape(b, n, pool, 2).any(-1).sum(-1)
                * xin.reshape(b, n, pool, 2).any(-1).sum(-1)).sum().item())
    touched = roi_touched_bytes(
        feats, boxes, torch.ones(b, n, dtype=torch.bool, device=dev),
        strides, pool, levels=levels)
    nbytes = bins * c * 4 + touched + b * n * (20 + 16)
    by_bytes = 1e3 * nbytes / PEAK_BYTES
    by_ops = 1e3 * 16 * c * samples / PEAK_F32_FLOPS
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def check_roi_box_grad(label, feats, boxes, strides, pool, grad_out, levels,
                       phase="so-train"):
    """B1e on one training launch's own inputs (or phase 3's synthetic
    ones) against autograd of the plain version with respect to the boxes
    (multilevel_roi_align_box_vjp), with the path's features and with
    them in float32: within B1E_REL of max |plain|; two launches agree bit
    for bit. Times: the wrapper's CUDA-event time and the plain version's
    (median of 15), the kernel's device time (torch.profiler, nothing else
    in its profile), the bound (roi_box_grad_bound_ms). Returns a dict."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA

    def kernel(f=feats):
        return RA.multilevel_roi_align_box_grad_cuda(f, boxes, strides, pool,
                                                     grad_out, levels)

    def plain(f=feats):
        return RA.multilevel_roi_align_box_vjp(f, boxes, strides, pool,
                                               grad_out, levels)
    entry = {}
    runs = [("f32", [f.float() for f in feats])]
    if feats[0].dtype != torch.float32:
        runs.insert(0, (str(feats[0].dtype)[6:], feats))
    for name, fs in runs:
        got, ref = kernel(fs), plain(fs)
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        if not (torch.isfinite(got).all() and err <= B1E_REL * scale):
            raise AssertionError(f"{phase} roi_align_box_grad {label} "
                                 f"{name}: max |kernel - plain| {err} > "
                                 f"{B1E_REL} x {scale}")
        if not torch.equal(got.view(torch.int32),
                           kernel(fs).view(torch.int32)):
            raise AssertionError(f"{phase} roi_align_box_grad {label} "
                                 f"{name}: two launches differ")
        entry["err"] = max(entry.get("err", 0.0), err)
        entry["share"] = max(entry.get("share", 0.0), err / max(scale,
                                                                1e-30))
    entry["ms"], entry["plain_ms"] = median_ms([kernel, plain])
    others = []
    entry["device_ms"] = device_ms(kernel, {"grad": "roi_align_box_grad"},
                                   runs=15, others=others)["grad"]
    if others:
        raise AssertionError(f"{phase} roi_align_box_grad {label}: other "
                             f"device work in its profile "
                             f"{sorted(set(others))}")
    entry["bound_ms"], entry["bound_by"] = roi_box_grad_bound_ms(
        feats, boxes, strides, pool, levels)
    entry["bound_share"] = entry["bound_ms"] / entry["device_ms"]
    where = ("the step's own inputs" if phase == "so-train"
             else "synthetic inputs")
    log(phase, f"roi_align_box_grad (B1e) on {where}, {label}:"
        f" max |kernel - plain| {entry['err']:.3g} ({entry['share']:.3g} of "
        f"max |plain|, bound {B1E_REL}; {', '.join(r for r, _ in runs)} "
        f"features); two launches bitwise equal; kernel {entry['ms']:.4f} "
        f"ms, plain {entry['plain_ms']:.4f} ms (median of 15, CUDA events), "
        f"device {entry['device_ms']:.4f} ms (torch.profiler, 15 calls), "
        f"bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}), "
        f"{entry['bound_share']:.1%} of it")
    return entry


def phase_box_grad_kernels():
    """Phase 3, B1e: the box-gradient kernel at B1E_CASES through
    check_roi_box_grad (bf16 features and the same in float32, within
    B1E_REL of max |plain|, two launches bitwise equal, only its kernel in
    its profile; wrapper, plain and device times, bound). Returns {label:
    entry}."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    gen = torch.Generator(device="cuda").manual_seed(3)
    results = {}
    for label, kind, n, pool, c, off16 in B1E_CASES:
        feats, boxes, grad_out = box_grad_case(gen, kind, n, c,
                                               torch.bfloat16, off16)
        levels = RA.fpn_map_rois_to_levels(boxes)
        results[label] = check_roi_box_grad(label, feats, boxes, STRIDES,
                                            pool, grad_out(pool), levels,
                                            phase="kernels")
        del feats, boxes
    torch.cuda.empty_cache()
    return results


def so_launch_inputs(model, x):
    """One forward of ``model`` (with the small-object heads) on ``x``,
    recording the SO pooling's B1 call: the launch with N = n_so x R +
    so_person_topk boxes at P=7. Returns ((feats, strides, boxes, valid),
    the forward's output)."""
    import torch
    from object_detection_tracking_tpu_torch.models import faster_rcnn as FR
    cfg = model.config
    calls = []
    real = FR.multilevel_roi_align_cuda

    def recording(features, boxes, strides, output_size, valid=None,
                  levels=None):
        calls.append((list(features), tuple(strides), boxes, valid,
                      output_size))
        return real(features, boxes, strides, output_size, valid=valid,
                    levels=levels)
    FR.multilevel_roi_align_cuda = recording
    try:
        with torch.inference_mode():
            out = model(x)
    finally:
        FR.multilevel_roi_align_cuda = real
    n = len(model.so_ids) * cfg.result_per_im + (
        cfg.so_person_topk if cfg.use_so_association else 0)
    so = [c[:4] for c in calls if c[2].shape[1] == n and c[4] == 7]
    if len(so) != 1:
        raise AssertionError(f"small-objects: {len(so)} SO pooling "
                             f"launches among {len(calls)} (N={n})")
    return so[0], out


def phase_small_objects(tmp, actev_prof):
    """Phase 17(a): the small-object heads with the person association on
    phase 7's detector and weights (R101-FPN v4, masks, fused backbone,
    bf16, B=8, 1920x1080), SO_FORWARDS forwards of one synthetic batch
    with the launch counts set to 0 just before: B1 4 times a forward
    (proposals, final boxes, masks, the SO pooling), B2 3 times; the SO
    outputs finite; the SO pooling's launch redone on its own inputs
    against the plain version (timed); host wall and kernel time with and
    without the heads beside phase 8's. Returns a summary dict."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.params import \
        init_small_objects

    device = torch.device("cuda")
    _, cfg, tree = actev_setup(tmp, device)
    cfg = dataclasses.replace(cfg, use_small_object_head=True,
                              use_so_association=True)
    tree["small_objects"] = init_small_objects(cfg, seed=0)
    model = build_model(cfg, tree, device)
    names = [n for n in cfg.small_objects if n in cfg.classname2id]
    video = SyntheticVideo(BATCH, seed=1, h=ACTEV_H, w=ACTEV_W)
    x = torch.from_numpy(np.stack([video.read()[1] for _ in range(BATCH)])
                         ).to(device)
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        RA.multilevel_roi_align_cuda.launches = 0
        RS.fused_bottleneck_stage_cuda.launches = 0
        for _ in range(SO_FORWARDS):
            out = model(x)
        torch.cuda.synchronize()
    roi_n = RA.multilevel_roi_align_cuda.launches
    stage_n = RS.fused_bottleneck_stage_cuda.launches
    if roi_n != 4 * SO_FORWARDS or stage_n != 3 * SO_FORWARDS:
        raise AssertionError(f"{SO_FORWARDS} forwards with the SO heads "
                             f"launched roi_align {roi_n} and the stage "
                             f"{stage_n} times, want 4 and 3 a forward")
    r = cfg.result_per_im
    want = {"so_final_boxes": (BATCH, r, 4), "so_final_labels": (BATCH, r),
            "so_final_probs": (BATCH, r), "so_final_valid": (BATCH, r)}
    for k, shape in want.items():
        if tuple(out[k].shape) != shape or not torch.isfinite(
                out[k].float()).all():
            raise AssertionError(f"small-objects: {k} {tuple(out[k].shape)}"
                                 f" (want {shape}) or not finite")
    valid = out["so_final_valid"]
    labels = out["so_final_labels"][valid]
    if not ((labels >= 1) & (labels <= len(names))).all():
        raise AssertionError(f"small-objects: SO labels {labels.unique()}")
    per_image = valid.sum(1).tolist()
    by_name = {n: int((labels == i + 1).sum()) for i, n in enumerate(names)}
    log("small-objects", f"R101-FPN v4 + masks + SO heads ({names}, person "
        f"association, top {cfg.so_person_topk} persons), {cfg.compute_dtype}, "
        f"B={BATCH}, "
        f"{ACTEV_W}x{ACTEV_H}: {SO_FORWARDS} forwards launched roi_align "
        f"{roi_n} and the bottleneck stage {stage_n} times (4 and 3 a "
        f"forward); so_final_valid per image {per_image}, by class "
        f"{by_name}; outputs finite")

    ((feats, strides, boxes, pool_valid), _), seen = record_nms(
        lambda: so_launch_inputs(model, x))
    nms = check_nms_launches("small-objects", seen, [
        "proposals", "small objects", "persons", "small-object predictions",
        "predictions"])
    label = f"SO pooling N={boxes.shape[1]} P=7"
    roi = check_roi_launch("small-objects", label, feats, strides, boxes,
                           pool_valid, 7, True)
    res = {"forwards": SO_FORWARDS, "roi_launches": roi_n,
           "stage_launches": stage_n, "so_valid_per_image": per_image,
           "so_by_class": by_name,
           "pool_valid_slots": int(pool_valid.sum().item()),
           "pool_slots": int(pool_valid.numel()), "roi": {label: roi},
           "nms": nms}
    prof = phase_profile(model, x, "small-objects")
    heads = model.small_objects
    model.small_objects = None          # the same model without the heads
    try:
        prof_off = phase_profile(model, x, "small-objects")
    finally:
        model.small_objects = heads
    res.update(wall_ms=prof["wall_ms"], kernel_ms=prof["kernel_ms"],
               wall_off_ms=prof_off["wall_ms"],
               kernel_off_ms=prof_off["kernel_ms"], by_kind=prof["by_kind"])
    log("small-objects", f"forward host wall {prof['wall_ms']:.1f} ms with "
        f"the SO heads, {prof_off['wall_ms']:.1f} ms without (phase 8: "
        f"{actev_prof['wall_ms']:.1f}); kernel time {prof['kernel_ms']:.1f}"
        f" / {prof_off['kernel_ms']:.1f} ms (phase 8: "
        f"{actev_prof['kernel_ms']:.1f}); valid pooling slots "
        f"{res['pool_valid_slots']} of {res['pool_slots']}")
    del model, x, out
    torch.cuda.empty_cache()
    return res


def phase_so_train(tmp):
    """Phase 17(b): cli/main.py train --use_small_object_head at phase 9's
    settings (R101-FPN v4, masks, bf16, B=2, freeze=2, random weights from
    seed 0 through --load_from, a constant learning rate), SO_TRAIN_STEPS
    steps on one in-memory batch whose gt boxes are Person, Prop, Vehicle
    and Bike in turn; B1 and B1b 3 times a step (box head, SO pooling,
    mask head) and B1e once (the SO pooling's boxes); the losses,
    so_label_loss among them, finite; the step split by CUDA events; then
    B1, B1b and B1e on the SO pooling's own inputs of one step, read off
    its autograd graph, against their plain versions. Returns a summary."""
    import torch
    from object_detection_tracking_tpu_torch.cli import main as train_cli
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            save_npz_tree)

    device = torch.device("cuda")
    args = train_cli.get_args([
        "train", "--add_mask", "--use_small_object_head", "--im_batch_size",
        str(TRAIN_BATCH), "--num_step", str(SO_TRAIN_STEPS),
        "--lr_schedule", "constant", "--warmup_steps", "0",
        "--clip_gradient_norm", "10", "--save_every", str(SO_TRAIN_STEPS),
        "--outbasepath", os.path.join(tmp, "so_train"), "--device", "cuda"])
    cfg = train_cli.build_config(args, True, device)
    got = (cfg.resnet_depth, cfg.use_dilations, cfg.num_class, cfg.add_mask,
           cfg.compute_dtype, cfg.freeze, cfg.roi_align_train_impl,
           cfg.use_small_object_head, cfg.use_so_association)
    if got != (101, True, 16, True, "bfloat16", 2, "pallas", True, False):
        raise AssertionError(f"not the train CLI's v4 default with "
                             f"--use_small_object_head: {got}")
    tree = init_params(cfg, seed=0)
    for gname, group in tree["resnet"].items():    # as in phase 9
        if gname.startswith("group"):
            for blk in group.values():
                blk["conv3"]["bn"]["gamma"] *= 0.2
    init = os.path.join(tmp, "so_train_init.npz")
    save_npz_tree(init, tree)
    args.load_from = init
    images, boxes, labels, valid, masks = train_batch(cfg, args.max_gt)
    ids = [cfg.classname2id[n] for n in ("Person", "Prop", "Vehicle",
                                         "Bike")]
    for j in range(labels.shape[1]):
        labels[:, j] = valid[:, j] * ids[j % 4]
    batch = (images, boxes, labels, valid, masks)

    counters = (RA.multilevel_roi_align_cuda,
                RA.multilevel_roi_align_backward_cuda,
                RA.multilevel_roi_align_box_grad_cuda)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    res = train_cli.mode_train(args, dataset=MemoryBatches(
        batch, SO_TRAIN_STEPS))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    losses = res["losses"]
    log("so-train", f"main.py train --use_small_object_head: R101-FPN v4 + "
        f"masks + SO heads, {ACTEV_W}x{ACTEV_H}, B={TRAIN_BATCH}, bf16, "
        f"{res['step']} steps in {wall:.2f} s wall (build, load and "
        f"checkpoint included); total loss per step: "
        + ", ".join(f"{v:.4f}" for v in losses) + f"; launches {launches} "
        f"(3, 3 and 1 a step)")
    want = [3 * SO_TRAIN_STEPS, 3 * SO_TRAIN_STEPS, SO_TRAIN_STEPS]
    if list(launches.values()) != want:
        raise AssertionError(f"{SO_TRAIN_STEPS} steps launched {launches}, "
                             f"want {want}")
    if res["step"] != SO_TRAIN_STEPS or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"{res['step']} steps, losses {losses}")
    trainer = res["trainer"]
    tb = [torch.from_numpy(a).to(device) for a in batch]
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
        if 0 < i:
            for k, (a, b) in zip(split, zip(ev, ev[1:])):
                split[k].append(a.elapsed_time(b))
    split = {k: sorted(v)[len(v) // 2] for k, v in split.items()}
    log("so-train", f"one bf16 step, median of {TRAIN_TIMED} (CUDA events): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f"; {sum(split.values()):.2f} ms in all")

    # B1, B1b and B1e on the SO pooling's own inputs of one step
    gen.manual_seed(1000 + TRAIN_TIMED + 1)
    step_losses = trainer.losses(*tb, generator=gen)
    values = {k: v.item() for k, v in step_losses.items()}
    if "so_label_loss" not in values or not all(
            math.isfinite(v) for v in values.values()):
        raise AssertionError(f"so-train: losses {values}")
    log("so-train", "one step's losses: " + ", ".join(
        f"{k} {v:.4f}" for k, v in values.items()))
    n_so = len([n for n in cfg.small_objects if n in cfg.classname2id])
    captured = roi_backward_inputs(
        step_losses["total_loss"],
        key=lambda node: (node.output_size,
                          node.saved_tensors[0].shape[1]))
    so_key = (7, n_so * cfg.result_per_im)
    if so_key not in captured:
        raise AssertionError(f"so-train: no SO pooling node among "
                             f"{sorted(captured)}")
    feats, boxes, strides, grad_out, levels = captured[so_key]
    feats = [f.detach() for f in feats]
    boxes = boxes.detach()
    label = f"SO pooling N={boxes.shape[1]} P=7"
    out = {"steps": res["step"], "losses": losses, "wall_s": wall,
           "launches": launches, "step_ms": split, "step_losses": values}
    out["roi"] = {label: check_roi_launch("so-train", label, feats, strides,
                                          boxes, None, 7, True)}
    out["bwd"] = {label: check_roi_backward(label, feats, boxes, strides, 7,
                                            grad_out, levels, "so-train")}
    out["box_grad"] = {label: check_roi_box_grad(label, feats, boxes,
                                                 strides, 7, grad_out,
                                                 levels)}
    del captured, trainer, res, step_losses
    torch.cuda.empty_cache()
    return out


def _varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _pb_varint(field, value):
    return _varint(field << 3) + _varint(value)


def _pb_bytes(field, payload):
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _leveldb_block(entries):
    """A leveldb block: entries without prefix compression, one restart."""
    body = b""
    for key, value in entries:
        body += _varint(0) + _varint(len(key)) + _varint(len(value))
        body += key + value
    return body + (0).to_bytes(4, "little") + (1).to_bytes(4, "little")


def write_tf_bundle(prefix, tensors):
    """A TF V2 checkpoint (tensor bundle) of ``tensors`` (name -> numpy
    float32/int32/int64 array), written from the format's specs (leveldb
    table_format.md, tensor_bundle.proto) as tests/test_tf_ckpt.py
    write_bundle writes it: ``<prefix>.index`` and one data shard, each
    tensor's raw little-endian bytes streamed to the shard."""
    enums = {"float32": 1, "int32": 3, "int64": 9}
    entries, offset = [], 0
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        for name in sorted(tensors):
            arr = tensors[name]
            shape = b"".join(_pb_bytes(2, _pb_varint(1, d))
                             for d in arr.shape)
            entries.append((name.encode(),
                            _pb_varint(1, enums[str(arr.dtype)])
                            + _pb_bytes(2, shape) + _pb_varint(4, offset)
                            + _pb_varint(5, arr.nbytes)))
            f.write(arr.tobytes())
            offset += arr.nbytes
    out = b""
    handles = []
    for block in (_leveldb_block([(b"", _pb_varint(1, 1))] + entries),
                  _leveldb_block([])):
        handles.append(_varint(len(out)) + _varint(len(block)))
        out += block + b"\x00" * 5            # type 0 (raw), a crc
    index = _leveldb_block([(b"\xff", handles[0])])
    footer = handles[1] + _varint(len(out)) + _varint(len(index))
    out += index + b"\x00" * 5
    footer += b"\x00" * (40 - len(footer))
    footer += (0xdb4775248b80fb57).to_bytes(8, "little")
    with open(prefix + ".index", "wb") as f:
        f.write(out + footer)


def reference_names(tree, fpn_channels):
    """The reference's TF variable names (no ':0') for a JAX-layout tree,
    the inverse of utils/weights.py's name map, as tests/test_weights.py
    _to_tf_names builds them: the backbone at root scope (no resnet/), BN
    statistics under .../mean/EMA and .../variance/EMA, fc6's rows in the
    reference's C-major (C,7,7) order."""
    import numpy as np
    flat = {}

    def rec(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                rec(v, path + [k])
                continue
            name = (path[1:] if path[0] == "resnet" else path) + [k]
            if len(name) >= 2 and name[-2] == "bn" and k in ("mean",
                                                            "variance"):
                name.append("EMA")
            flat["/".join(name)] = np.ascontiguousarray(v, np.float32)

    rec(tree, [])
    fc6 = flat["fastrcnn/fc6/W"]
    d = fc6.shape[1]
    flat["fastrcnn/fc6/W"] = np.ascontiguousarray(
        fc6.reshape(7, 7, fpn_channels, d).transpose(2, 0, 1, 3)
        .reshape(-1, d))
    return flat


def timed_load(args, cfg, device):
    """The CLI's load_model with ``args``' --model_path: (model, host
    seconds, what the loader printed)."""
    import io
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        model = cli.load_model(args, cfg, device)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, buf.getvalue().strip()


def same_tree(got, want, label):
    """Fails unless the two trees have the same leaves, bit for bit;
    returns their number."""
    import numpy as np

    def flat(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, v
    got, want = dict(flat(got)), dict(flat(want))
    if got.keys() != want.keys():
        raise AssertionError(f"{label}: leaves differ: "
                             f"{sorted(got.keys() ^ want.keys())[:6]}")
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} leaves differ, e.g. "
                             f"{bad[:4]}")
    return len(want)


def pyav_drive(tmp, cfg, model):
    """Where av imports: CKPT_PYAV_FRAMES frames of phase 7's video written
    as an MPEG-4 .avi by av, then decoded through the PyAV reader by
    process_video --use_lijun_video_loader (every frame, B=8), the launch
    counts set to 0 just before. Returns a summary."""
    import av
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.runtime import DetectionRunner

    path = os.path.join(tmp, "pyav.avi")
    video = SyntheticVideo(CKPT_PYAV_FRAMES, h=ACTEV_H, w=ACTEV_W)
    with av.open(path, mode="w") as out:
        stream = out.add_stream("mpeg4", rate=30)
        stream.width, stream.height = ACTEV_W, ACTEV_H
        stream.pix_fmt = "yuv420p"
        for _ in range(CKPT_PYAV_FRAMES):
            frame = av.VideoFrame.from_ndarray(video.read()[1],
                                               format="bgr24")
            for packet in stream.encode(frame):
                out.mux(packet)
        for packet in stream.encode():
            out.mux(packet)
    args = actev_args(tmp, os.path.join(tmp, "pyav_tracks"),
                      "--use_lijun_video_loader", "--frame_gap", "1")
    runner = CheckedRunner(DetectionRunner(model), cfg.result_per_im,
                           cfg.num_class, masks=True)
    RA.multilevel_roi_align_cuda.launches = 0
    RS.fused_bottleneck_stage_cuda.launches = 0
    frames = cli.process_video(args, cfg, runner, path, cfg.classid2name,
                               None)
    torch.cuda.synchronize()
    roi_n = RA.multilevel_roi_align_cuda.launches
    stage_n = RS.fused_bottleneck_stage_cuda.launches
    want = CKPT_PYAV_FRAMES // BATCH
    if (frames, runner.batches, roi_n, stage_n) != (
            CKPT_PYAV_FRAMES, want, 3 * want, 3 * want):
        raise AssertionError(
            f"PyAV decode: {frames} frames in {runner.batches} batches, "
            f"roi_align {roi_n} and stage {stage_n} launches")
    return {"frames": frames, "batches": runner.batches,
            "roi_launches": roi_n, "stage_launches": stage_n,
            "av": av.__version__, "bytes": os.path.getsize(path)}


def phase_ckpt(tmp, model, x, actev):
    """The reference's checkpoints on the main path (phase 18 of the module
    note): phase 7's tree as a TF V2 bundle and a tensorpack-named .npz
    under the reference's names, each loaded through the CLI's load_model
    and held equal to the tree; the bundle's model driven through
    process_video with --log_time_and_gpu, its launches checked on one
    forward's own inputs and its detections matched to phase 7's model's;
    the strict native load's KeyError; --use_lijun_video_loader. Returns a
    summary dict."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.cli import obj_detect_tracking \
        as cli
    from object_detection_tracking_tpu_torch.params import params_to_jax

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    cfg = model.config
    tree = params_to_jax(model)
    names = reference_names(tree, cfg.fpn_num_channel)
    # what a training run saves beside the weights; the loader skips them
    names.update({"global_step": np.array(120000, np.int64),
                  "fastrcnn/fc7/W/Momentum": np.zeros_like(
                      names["fastrcnn/fc7/W"])})
    prefix = os.path.join(tmp, "model.ckpt-120000")
    npz = os.path.join(tmp, "tensorpack.npz")
    t0 = time.perf_counter()
    write_tf_bundle(prefix, names)
    np.savez(npz, **{k + ":0": v for k, v in names.items()})
    sizes = {"bundle": os.path.getsize(prefix + ".index") + os.path.getsize(
        prefix + ".data-00000-of-00001"), "npz": os.path.getsize(npz)}
    res = {"arrays": len(names), "bytes": sizes,
           "write_s": time.perf_counter() - t0}
    util = os.path.join(tmp, "util.json")
    tracking = os.path.join(tmp, "ckpt_tracks")
    for kind, path in (("npz", npz), ("bundle", prefix + ".index")):
        args = actev_args(tmp, tracking, "--model_path", path,
                          "--log_time_and_gpu", "--save_util_log_to", util)
        m, secs, said = timed_load(args, cfg, device)
        n = same_tree(params_to_jax(m), tree, f"{kind} load")
        res[f"{kind}_load_s"] = secs
        log("ckpt", f"--model_path {os.path.basename(path)} "
            f"({sizes[kind] / 1e6:.1f} MB, reference names): loaded by "
            f"load_model in {secs:.2f} s host wall ({said!r}); "
            f"params_to_jax equal to phase 7's tree bit for bit, {n} "
            f"leaves")
        if kind == "npz":
            del m
    # the bundle's model on the main path, as the CLI's main runs it
    interval, cli.PERF_INTERVAL = cli.PERF_INTERVAL, CKPT_PERF_INTERVAL
    try:
        with cli.perf_logging(args, device) as perf:
            runner, frames, wall, roi_n, stage_n, rows = drive_actev(
                args, cfg, m, "ckpt")
    finally:
        cli.PERF_INTERVAL = interval
    summary = perf.summary()
    with open(util) as f:
        series = json.load(f)
    if sorted(series) != ["cpu_percent", "device_bytes", "rss_mb", "time"] \
            or not summary.get("device_bytes_max", 0) > 0:
        raise AssertionError(f"--log_time_and_gpu: series {sorted(series)},"
                             f" summary {summary}")
    res.update(frames=frames, batches=runner.batches, wall_s=wall,
               roi_launches=roi_n, stage_launches=stage_n, track_rows=rows,
               actev_track_rows=actev["track_rows"], perf=summary,
               samples=len(series["time"]))
    log("ckpt", f"the bundle's model through process_video with "
        f"--log_time_and_gpu: {frames} frames in {runner.batches} batches, "
        f"{wall:.3f} s wall; launches: roi_align {roi_n}, bottleneck stage "
        f"{stage_n} (3 per batch each); MOT rows/ids {rows} (phase 7: "
        f"{actev['track_rows']}); {len(series['time'])} samples every "
        f"{CKPT_PERF_INTERVAL} s, device_bytes max "
        f"{summary['device_bytes_max'] / 1e9:.3f} GB, rss max "
        f"{summary['rss_mb_max']:.0f} MB")
    with torch.inference_mode():
        out = m(x)
        ref = {k: v.cpu().numpy() for k, v in model(x).items()}
    share, total = match_share(ref, {k: v.cpu().numpy()
                                     for k, v in out.items()})
    if not share >= MATCH_MIN:
        raise AssertionError(f"bundle-loaded model matches {share:.4f} of "
                             f"{total} of phase 7's detections")
    log("ckpt", f"one forward on phase 7's batch: {share:.4f} of {total} "
        f"detections of phase 7's model matched (bound {MATCH_MIN})")
    res.update(match=share, check=main_path_kernel_check(m, x, out, "ckpt"))
    del m, out

    bad = os.path.join(tmp, "bad.npz")
    np.savez(bad, **{"resnet/conv0/W": tree["resnet"]["conv0"]["W"],
                     "fastrcnn/bogus/W": np.zeros((2, 2), np.float32)})
    try:
        timed_load(actev_args(tmp, tracking, "--model_path", bad), cfg,
                   device)
    except KeyError as e:
        log("ckpt", f"a native npz with a name the model lacks: KeyError "
            f"{e}")
    else:
        raise AssertionError("a native npz with an extra name loaded")
    if importlib.util.find_spec("av") is None:
        try:
            actev_args(tmp, tracking, "--use_lijun_video_loader")
        except RuntimeError as e:
            log("ckpt", f"av does not import: --use_lijun_video_loader "
                f"raises RuntimeError ({e})")
        else:
            raise AssertionError("--use_lijun_video_loader without av "
                                 "did not raise")
        res["pyav"] = None
    else:
        res["pyav"] = pyav_drive(tmp, cfg, model)
        log("ckpt", f"--use_lijun_video_loader: {res['pyav']}")
    res["phase_s"] = time.perf_counter() - t_phase
    log("ckpt", f"phase 18 took {res['phase_s']:.1f} s of host wall")
    return res


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_parallel(tmp):
    """Data parallelism on the card (phase 19 of the module note):
    main.py train through parallel/mesh.py under NCCL at world size 1,
    against its one-process path on the same init, batch and draws, bit for
    bit. Returns a summary dict."""
    import torch
    import torch.distributed as dist
    from object_detection_tracking_tpu_torch.cli import main as train_cli
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.parallel import mesh as par
    from object_detection_tracking_tpu_torch.params import (
        _leaves, init_params, save_npz_tree)
    from object_detection_tracking_tpu_torch.train import Trainer

    device = torch.device("cuda")
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    saved_env = {k: os.environ.get(k) for k in env}
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    os.environ.update(env)
    # both runs take the same, deterministic, cuDNN algorithms, so that the
    # sharded and the plain path can be bit-equal
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        args = train_cli.get_args([
            "train", "--add_mask", "--im_batch_size", str(TRAIN_BATCH),
            "--num_step", str(PAR_STEPS), "--lr_schedule", "constant",
            "--warmup_steps", "0", "--clip_gradient_norm", "10",
            "--save_every", "1000", "--outbasepath",
            os.path.join(tmp, "dp"), "--device", "cuda"])
        cfg = train_cli.build_config(args, True, device)
        got = (cfg.resnet_depth, cfg.use_dilations, cfg.num_class,
               cfg.add_mask, cfg.compute_dtype, cfg.freeze,
               cfg.roi_align_train_impl, cfg.max_size, cfg.short_edge_size)
        if got != (101, True, 16, True, "bfloat16", 2, "pallas", ACTEV_W,
                   ACTEV_H):
            raise AssertionError(f"not phase 9's settings: {got}")
        tree = init_params(cfg, seed=0)
        for gname, group in tree["resnet"].items():    # as in phase 9
            if gname.startswith("group"):
                for blk in group.values():
                    last = blk["conv3"] if "conv3" in blk else blk["conv2"]
                    last["bn"]["gamma"] *= 0.2
        args.load_from = os.path.join(tmp, "init.npz")
        save_npz_tree(args.load_from, tree)
        batch = train_batch(cfg, args.max_gt)
        data = MemoryBatches(batch, PAR_STEPS)

        RA.multilevel_roi_align_cuda.launches = 0
        RA.multilevel_roi_align_backward_cuda.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_cli.mode_train(args, dataset=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd_n = RA.multilevel_roi_align_cuda.launches
        bwd_n = RA.multilevel_roi_align_backward_cuda.launches
        backend, world = dist.get_backend(), dist.get_world_size()
        losses = res["losses"]
        log("parallel", f"main.py train under torchrun's variables: "
            f"backend {backend}, world size {world}; {res['step']} steps of "
            f"R{cfg.resnet_depth}-FPN v{args.version} + masks, "
            f"{ACTEV_W}x{ACTEV_H}, B={TRAIN_BATCH}, {cfg.compute_dtype} in "
            f"{wall:.2f} s "
            f"wall (init, build and load included); total loss per step: "
            + ", ".join(f"{v:.4f}" for v in losses)
            + f"; launches: roi_align {fwd_n}, roi_align_backward {bwd_n} "
            f"(2 per step each)")
        if backend != "nccl" or world != 1:
            raise AssertionError(f"process group {backend} x{world}")
        if res["step"] != PAR_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"steps {res['step']}, losses {losses}")
        if fwd_n != 2 * PAR_STEPS or bwd_n != 2 * PAR_STEPS:
            raise AssertionError(f"{PAR_STEPS} steps launched roi_align "
                                 f"{fwd_n} and roi_align_backward {bwd_n} "
                                 f"times, want 2 per step each")
        ckpts = sorted(os.listdir(train_cli.checkpoint_dir(args)))
        if ckpts != [f"step_{PAR_STEPS}.pt"]:
            raise AssertionError(f"checkpoints {ckpts}")

        # the one-process path: the same init, batch and draws
        args.outbasepath = os.path.join(tmp, "one")
        one_model = train_cli.build_model(args, cfg, device)
        one = train_cli.train(args, cfg, one_model, data)
        dp_model = res["trainer"].model
        diff = {"/".join(path): float((t - u).abs().max())
                for (path, t, _), (_, u, _) in zip(_leaves(dp_model),
                                                   _leaves(one_model))
                if not torch.equal(t, u)}
        log("parallel", f"params after {PAR_STEPS} steps, sharded path vs "
            f"one-process path: {len(diff)} of "
            f"{sum(1 for _ in _leaves(one_model))} leaves differ"
            + (f" (largest {max(diff.values()):.3g} at "
               f"{max(diff, key=diff.get)})" if diff else
               ", bit for bit equal")
            + f"; losses {one['losses']} vs {losses}")
        if diff or one["losses"] != losses:
            raise AssertionError(f"sharded and one-process paths differ at "
                                 f"{sorted(diff)[:5]}")
        del one
        torch.cuda.empty_cache()

        # the sharded step against the one-process step by CUDA events
        mesh = par.make_mesh(device=device)
        trainer, step_fn = par.make_sharded_train_step(dp_model,
                                                       res["trainer"].cfg,
                                                       mesh)
        plain = Trainer(one_model, res["trainer"].cfg)
        tb = [torch.from_numpy(x).to(device) for x in batch]
        gen = torch.Generator(device=device)
        times = {"sharded": [], "one-process": [], "all-reduce": []}
        params = list(trainer.opt.params.values())
        for i in range(PAR_TIMED + 1):
            for name in ("sharded", "one-process"):
                gen.manual_seed(2000 + i)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                if name == "sharded":
                    step_fn(*tb, generator=gen)
                else:
                    plain.step(*tb, generator=gen)
                ev[1].record()
                ev[1].synchronize()
                if i:
                    times[name].append(ev[0].elapsed_time(ev[1]))
            # the flat all-reduce a data axis of several ranks makes (one
            # rank skips it), here over NCCL at world size 1
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            dist.all_reduce(flat, group=mesh.data_group)
            ev[1].record()
            ev[1].synchronize()
            if i:
                times["all-reduce"].append(ev[0].elapsed_time(ev[1]))
        step_ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        n_grad = sum(p.numel() for p in params)
        if not torch.equal(flat, torch.cat([p.grad.reshape(-1)
                                            for p in params])):
            raise AssertionError("an NCCL all-reduce at world size 1 "
                                 "changed the gradients")
        log("parallel", f"one step, median of {PAR_TIMED} in turns (CUDA "
            f"events, the batch on the card for both): sharded "
            f"{step_ms['sharded']:.2f} ms (the rank's rows and draws; no "
            f"gradient all-reduce at one data rank), one-process "
            f"Trainer.step {step_ms['one-process']:.2f} ms; a flat NCCL "
            f"all-reduce of the {n_grad} float32 gradients (concatenation "
            f"included), as several data ranks make it, "
            f"{step_ms['all-reduce']:.2f} ms, its result equal to its "
            f"input")

        # B1 and B1b on one sharded step's own inputs, read off its graph
        gen.manual_seed(3000)
        step_losses = trainer.losses(*tb, generator=gen)  # one rank: all rows
        captured = roi_backward_inputs(step_losses["total_loss"])
        roi, bwd = {}, {}
        for pool in sorted(captured):
            feats, boxes, strides, grad_out, levels = captured[pool]
            label = f"N={boxes.shape[1]} P={pool}"
            roi[label] = check_roi_launch("parallel", label, feats, strides,
                                          boxes, None, pool, True)
            bwd[label] = check_roi_backward(label, feats, boxes, strides,
                                            pool, grad_out, levels)
        if len(roi) != 2:
            raise AssertionError(f"captured ROIAlign launches {sorted(roi)}")
        del captured, step_losses, trainer, plain, res
        torch.cuda.empty_cache()
        return {"backend": backend, "world_size": world,
                "steps": PAR_STEPS, "losses": losses, "wall_s": wall,
                "roi_align_launches": fwd_n,
                "roi_align_backward_launches": bwd_n,
                "bit_equal": not diff, "step_ms": step_ms,
                "grad_elements": n_grad, "roi": roi, "bwd": bwd}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = flags
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# phase 20's fresh process: loads the pack with JAX and the port's models
# blocked, runs fn on phase 7's frames, times the first
# call (the capture) and the replays, counts the kernels of one profiled
# replay by name; writes the outputs to an npz and prints one JSON line
PACK_CHILD = r"""
import json, sys, time
t_start = time.perf_counter()
for m in ("jax", "object_detection_tracking_tpu_torch.models"):
    sys.modules[m] = None
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from object_detection_tracking_tpu_torch import native
from object_detection_tracking_tpu_torch.runtime.aot import load_packed
pack_dir, frames, out_path, tries = sys.argv[1:5]
t_import = time.perf_counter() - t_start
t0 = time.perf_counter()
cfg, params, fn = load_packed(pack_dir, "cuda")
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
x = torch.from_numpy(np.load(frames)).cuda()
t0 = time.perf_counter()
out = fn(params, x)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
walls = []
for _ in range(7):
    t0 = time.perf_counter()
    out = fn(params, x)
    torch.cuda.synchronize()
    walls.append(1e3 * (time.perf_counter() - t0))
names = ("roi_align_fwd", "nms_keep_kernel")
for _ in range(int(tries)):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(params, x)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.self_device_time_total > 0 and "cuda" in
              str(e.device_type).lower()]
    if all(any(n in e.key for e in events) for n in names):
        break
kernels = {n: [sum(e.count for e in events if n in e.key),
               sum(e.self_device_time_total for e in events
                   if n in e.key) / 1e3] for n in names}
np.savez(out_path, **{k: v.cpu().numpy() for k, v in out.items()})
print(json.dumps({
    "import_s": t_import, "load_s": load_s, "load_split_s": fn.load_seconds,
    "first_call_s": first_s,
    "replay_ms": sorted(walls)[len(walls) // 2],
    "device_ms": sum(e.self_device_time_total for e in events) / 1e3,
    "kernels": kernels, "libraries": native.lib_paths,
    "models_imported": any(k.startswith(
        "object_detection_tracking_tpu_torch.models.") for k in sys.modules),
    "wall_s": time.perf_counter() - t_start}))
"""


def phase_pack(tmp, frames):
    """Phase 20: main.py pack at the CLI's defaults (R101-FPN v4, 16
    classes, 1080x1920, masks, bf16, backbone "xla" as JAX's pack keeps
    it) with B=8 and phase 7's weights through --load_from; a fresh
    process loads the pack (load_packed, the port's models blocked) and
    runs fn on phase 7's frames as one captured CUDA graph; its outputs
    against this process's live forward of the pack's config and weights
    (>= MATCH_MIN of the detections matched, outputs finite); B1 and N1 by
    name in a profiled replay. Returns a summary dict."""
    import numpy as np
    import torch
    from object_detection_tracking_tpu_torch.cli import main as pack_cli
    from object_detection_tracking_tpu_torch.config import DetectorConfig
    from object_detection_tracking_tpu_torch.ops import nms as N
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    from object_detection_tracking_tpu_torch.params import save_npz_tree

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    _, _, tree = actev_setup(tmp, device)
    init = os.path.join(tmp, "actev_tree.npz")
    save_npz_tree(init, tree)
    args = pack_cli.get_args([
        "pack", "--im_batch_size", str(BATCH), "--add_mask", "--device",
        "cuda", "--load_from", init, "--outbasepath",
        os.path.join(tmp, "runs"), "--modelname", "actev"])
    RA.multilevel_roi_align_cuda.launches = 0
    N.greedy_keep_cuda.launches = 0
    t0 = time.perf_counter()
    out_dir = pack_cli.mode_pack(args)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "config.json")) as f:
        raw = json.load(f)
    meta = raw.pop("pack")
    cfg = DetectorConfig.from_json(json.dumps(raw))
    got = (cfg.resnet_depth, cfg.use_dilations, cfg.use_frcnn_class_agnostic,
           cfg.num_class, cfg.add_mask, cfg.compute_dtype, cfg.backbone_impl,
           cfg.roi_align_impl, cfg.short_edge_size, cfg.max_size,
           meta["batch"], meta["kernels"])
    if got != (101, True, True, 16, True, "bfloat16", "xla", "pallas",
               ACTEV_H, ACTEV_W, BATCH, ["nms", "roi_align"]):
        raise AssertionError(f"not the CLI's v4 default pack: {got}")
    sizes = {name: os.path.getsize(os.path.join(out_dir, name)) / 1e6
             for name in ("params.npz", "forward.pt2")}
    sizes["kernels"] = sum(
        os.path.getsize(os.path.join(out_dir, "kernels", n))
        for n in os.listdir(os.path.join(out_dir, "kernels"))) / 1e6
    log("pack", f"main.py pack, R101-FPN v4 + masks, B={BATCH}, "
        f"{ACTEV_W}x{ACTEV_H}, {cfg.compute_dtype}: {pack_s:.2f} s wall "
        f"(build, load, "
        f"FLOP count, export, load_packed and one captured call); "
        f"params.npz {sizes['params.npz']:.1f} MB, forward.pt2 "
        f"{sizes['forward.pt2']:.2f} MB, kernels/ {sizes['kernels']:.2f} MB "
        f"({meta['kernels']}); launches counted in the pack's live runs: "
        f"roi_align {RA.multilevel_roi_align_cuda.launches}, nms "
        f"{N.greedy_keep_cuda.launches}")

    x_path = os.path.join(tmp, "frames.npy")
    np.save(x_path, frames.numpy())
    got_path = os.path.join(tmp, "packed_out.npz")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", PACK_CHILD, out_dir, x_path, got_path,
         str(PROFILE_TRIES)], capture_output=True, text=True, timeout=900,
        env=env)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"pack: the fresh process failed "
                             f"({proc.returncode}):\n{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(got_path) as data:
        packed = {k: data[k] for k in data.files}

    model = build_model(cfg, tree, device)
    x = frames.to(device)
    with torch.inference_mode():
        live_out, seen = record_nms(lambda: model(x))
        live = {k: v.cpu().numpy() for k, v in live_out.items()}
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
    live_ms = sorted(walls)[2]
    # the bounds of the replay's kernels, from the live forward's own
    # inputs (the replay's outputs equal its, bit for bit, below)
    _, feats, strides, roi_launches = forward_kernel_inputs(model, x,
                                                            live_out)
    bounds = {"roi_align_fwd": sum(
        roi_bound_ms(feats, boxes, valid, strides, pool)
        for _, boxes, valid, pool in roi_launches),
        "nms_keep_kernel": sum(
            nms_bound_ms(boxes, valid,
                         N.greedy_keep_plain(boxes, valid, thres))[0]
            for boxes, valid, thres in seen)}
    del model, live_out, feats, roi_launches, seen
    torch.cuda.empty_cache()
    if set(packed) != set(live):
        raise AssertionError(f"pack: outputs {sorted(packed)} against the "
                             f"live forward's {sorted(live)}")
    for k, v in packed.items():
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            raise AssertionError(f"pack: {k} not finite")
    share, total = match_share(live, packed)
    equal = sorted(k for k in live if np.array_equal(live[k], packed[k]))
    if not share >= MATCH_MIN:
        raise AssertionError(f"pack: the packed forward matches {share:.4f} "
                             f"of {total} live detections < {MATCH_MIN}")
    counts = {n: c for n, (c, _) in child["kernels"].items()}
    if counts != {"roi_align_fwd": 3, NMS_KERNEL: 2}:
        raise AssertionError(f"pack: one profiled replay launched {counts}, "
                             f"want B1 3 times and N1 twice")
    packed_libs = all(os.path.dirname(p) == os.path.join(out_dir, "kernels")
                      for p in child["libraries"].values())
    if child["models_imported"] or not packed_libs:
        raise AssertionError(f"pack: the fresh process imported a model or "
                             f"loaded a kernel from outside the pack: "
                             f"{child['libraries']}")
    res = {"pack_s": pack_s, "sizes_mb": sizes, "kernels": meta["kernels"],
           "child_s": child_s, "child": child, "live_ms": live_ms,
           "match": share, "detections": total, "equal_outputs": equal,
           "libraries_from_pack": packed_libs, "bound_ms": bounds}
    k = child["kernels"]
    log("pack", f"fresh process (jax and the port's models blocked): "
        f"{child['wall_s']:.2f} s in the process ({child_s:.2f} s with its "
        f"start); import {child['import_s']:.2f} s, load_packed "
        f"{child['load_s']:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in child["load_split_s"].items())
        + f"; kernels from the pack), first call "
        f"(warm-up, CUDA-graph capture, replay) {child['first_call_s']:.2f} "
        f"s; replay {child['replay_ms']:.2f} ms a batch of {BATCH} (host "
        f"wall, median of 7, synchronized) against the live forward's "
        f"{live_ms:.2f} ms (same config and weights, median of 5)")
    log("pack", f"one profiled replay: {child['device_ms']:.2f} ms of "
        f"kernels; roi_align_fwd x{k['roi_align_fwd'][0]} "
        f"{k['roi_align_fwd'][1]:.4f} ms (bound "
        f"{bounds['roi_align_fwd']:.4f} ms, bytes), N1 "
        f"x{k[NMS_KERNEL][0]} {k[NMS_KERNEL][1]:.4f} ms (bound "
        f"{bounds[NMS_KERNEL]:.4f} ms; the bounds from the live forward's "
        f"own launches) (launched inside the graph: the "
        f"wrappers' counters do not tick on a replay); against the live "
        f"forward: {share:.4f} of {total} detections matched (bound "
        f"{MATCH_MIN}), bit-equal outputs {equal}; outputs finite")
    res["wall_s"] = time.perf_counter() - t_phase
    log("pack", f"phase wall {res['wall_s']:.1f} s")
    return res


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


def so_box_grad_row(so_train, synthetic):
    """The kernels line's row of B1e: the SO pooling's launches of phase
    17's train steps, redone and timed on one step's own inputs; phase 3's
    synthetic cases beside them."""
    (label, entry), = so_train["box_grad"].items()
    return {
        "name": "roi_align_box_grad", "route": "cuda",
        "source": "object_detection_tracking_tpu_torch/csrc/roi_align.cu",
        "replaces": "object_detection_tracking_tpu/ops/roi_align.py:136",
        "launches": so_train["launches"][
            "multilevel_roi_align_box_grad_cuda"],
        "max_abs_err": entry["err"], "ms": entry["ms"],
        "device_ms": entry["device_ms"], "plain_ms": entry["plain_ms"],
        "bound_ms": entry["bound_ms"], "bound_share": entry["bound_share"],
        "bound_by": entry["bound_by"], "library_ms": None,
        "per_launch": so_train["box_grad"], "synthetic": synthetic,
        "shapes": f"phase 17's train steps (main.py train "
                  f"--use_small_object_head, B=2, 1088x1920 pyramid, "
                  f"C=256, bf16 features, float32 grad_out): {label}; "
                  f"launches over {SO_TRAIN_STEPS} steps; the rest on one "
                  f"step's own inputs (JAX has no kernel: XLA's autodiff "
                  f"of the exact gather gives the box gradient); "
                  f"synthetic: phase 3's B1E_CASES (B=2, 1088x1920 "
                  f"pyramid), each timed on bf16 features; max_abs_err "
                  f"the step's launch alone, the synthetic cases' under "
                  f"synthetic"}


def nms_kernel_row(main_res, actev, train, effdet, so, pack, synthetic):
    """The kernels line's row of N1: the ActEV forward's own two launches
    (proposals, predictions) redone and timed; every other path's own
    launches and phase 3's synthetic cases beside them."""
    launches = actev["nms"]
    paths = {"train": train["nms"], "effdet": effdet["nms"],
             "small_objects": so["nms"]}
    every = list(launches.values()) + list(synthetic.values()) + [
        e for p in paths.values() for e in p.values()]
    device = sum(r["device_ms"] for r in launches.values())
    bound = sum(r["bound_ms"] for r in launches.values())
    return {
        "name": "nms_greedy_keep", "route": "cuda",
        "source": "object_detection_tracking_tpu_torch/csrc/nms.cu",
        "replaces": "object_detection_tracking_tpu/ops/nms.py:33",
        "launches": actev["nms_launches"],
        "max_abs_err": max(r["err"] for r in every),
        "ms": sum(r["ms"] for r in launches.values()),
        "device_ms": device,
        "plain_ms": sum(r["plain_ms"] for r in launches.values()),
        "bound_ms": bound, "bound_share": bound / device,
        "bound_by": ("operations" if all(
            r["bound_by"] == "operations" for r in launches.values())
            else "bytes"),
        "library_ms": None, "per_launch": launches,
        "paths_per_launch": paths, "synthetic": synthetic,
        "r50_720p_launches": main_res["nms_launches"],
        "train_launches": train["nms_launches"],
        "packed_replay": {
            "launches": pack["child"]["kernels"][NMS_KERNEL][0],
            "device_ms": pack["child"]["kernels"][NMS_KERNEL][1],
            "bound_ms": pack["bound_ms"][NMS_KERNEL]},
        "shapes": "ActEV path, one bf16 forward's own launches (B=8, "
                  "1088x1920): proposals [8,5,1000] at IOU 0.7, "
                  "predictions [8,15,200] at 0.5; ms, device_ms (the "
                  "one keep-mask kernel), plain_ms (the Jacobi "
                  "fixpoint with its host convergence test) and bound_ms "
                  "summed over the two; launches: phase 7's 8 batches; "
                  "r50_720p_launches: phase 4's; max_abs_err: keep flags "
                  "that differ from the plain "
                  "version's, over every path and case; paths_per_launch: "
                  "a training step's proposals [2,5,2000], EfficientDet-d0 "
                  "[8,90,200], the small-object heads' five; synthetic: "
                  "phase 3's clustered cases at each path's shape; "
                  "library_ms: none (no torchvision on the card); JAX's "
                  "counterpart is the lax.while_loop of _greedy_keep, not "
                  "a Pallas kernel"}


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
    box_grad_synthetic = phase_box_grad_kernels()
    nms_synthetic = phase_nms_kernels()
    sres = phase_stage()
    kept = tempfile.TemporaryDirectory()    # phase 7's MOT files, for 15
    with tempfile.TemporaryDirectory() as tmp:
        model, x, main_res = phase_main_path(tmp)
        phase_profile(model, x)
        del model, x
        torch.cuda.empty_cache()
        model, unfused, x, actev = phase_actev(tmp)
        frames7 = x.cpu()                   # phase 7's frames, for 20
        shutil.copytree(os.path.join(tmp, "actev_tracks"),
                        os.path.join(kept.name, "actev_tracks"))
    prof = phase_profile(model, x, "actev-profile", unfused=unfused)
    with tempfile.TemporaryDirectory() as tmp:
        tmot = phase_tmot(tmp, model, x, actev)
    del unfused
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = phase_ckpt(tmp, model, x, actev)
    del model, x
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
    torch.cuda.empty_cache()
    with kept, tempfile.TemporaryDirectory() as tmp:
        reid = phase_reid(tmp, os.path.join(kept.name, "actev_tracks"))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        imgs = phase_imgs(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        so = phase_small_objects(tmp, prof)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        so_train = phase_so_train(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        parallel = phase_parallel(tmp)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        pack = phase_pack(tmp, frames7)
    imgs_roi = (list(imgs["check"]["roi"].values())
                + list(imgs["options_check"]["roi"].values())
                + [imgs["extract_box_feat"]])
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
              + [r["err"] for r in tq_roi]
              + [r["err"] for r in imgs_roi]
              + [r["err"] for r in so["roi"].values()]
              + [r["err"] for r in so_train["roi"].values()]
              + [r["err"] for r in ckpt["check"]["roi"].values()]
              + [r["err"] for r in parallel["roi"].values()])
    bwd = train["bwd"]
    _, k_ms, p_ms, b_ms, d_ms = kres[(1000, torch.bfloat16)]
    _, k100, p100, b100, d100 = kres[(100, torch.bfloat16)]
    bf = [sres[(name, "bfloat16")] for name, *_ in STAGES]
    stage_err = max([r["err"] for r in sres.values()]
                    + actev["check"]["stage"] + tmot["check"]["stage"]
                    + imgs["check"]["stage"]
                    + imgs["options_check"]["stage"]
                    + ckpt["check"]["stage"])
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
        "imgs_launches": imgs["default"]["roi_launches"],
        "imgs_per_launch": imgs["check"]["roi"],
        "imgs_options_launches": imgs["options"]["roi_launches"],
        "imgs_conv_head_launches": imgs["conv_head"]["roi_launches"],
        "imgs_effdet_launches": imgs["effdet"]["roi_launches"],
        "extract_box_feat": imgs["extract_box_feat"],
        "so_launches": so["roi_launches"],
        "so_per_launch": so["roi"],
        "so_train_launches": so_train["launches"][
            "multilevel_roi_align_cuda"],
        "so_train_per_launch": so_train["roi"],
        "ckpt_launches": ckpt["roi_launches"],
        "parallel_launches": parallel["roi_align_launches"],
        "parallel_per_launch": parallel["roi"],
        "packed_replay": {
            "launches": pack["child"]["kernels"]["roi_align_fwd"][0],
            "device_ms": pack["child"]["kernels"]["roi_align_fwd"][1],
            "bound_ms": pack["bound_ms"]["roi_align_fwd"]},
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
                  "and eval and its tracking passes, by tracker; imgs_*: "
                  "phase 16's image CLI (default path, timed on one "
                  "forward's own launches; the options; the conv head; "
                  "EfficientDet-d0), extract_box_feat: its one launch on "
                  "a batch's final boxes (N=100 P=7, no validity mask), "
                  "timed; so_*: phase 17's small-object heads, the SO "
                  "pooling's launch (N=310 P=7, B=8) of the forwards and "
                  "(N=300 P=7, B=2) of the train steps, timed on their own "
                  "inputs; parallel_*: phase 19's data-parallel train steps "
                  "(NCCL, world size 1; the training phase's shapes), "
                  "one step's launches timed on their own inputs; "
                  "packed_replay: phase 20's packed forward (backbone "
                  "xla), its launches and their device ms in one profiled "
                  "CUDA-graph replay, counted by kernel name, and their "
                  "bound from the live forward's own launches"},
        {"name": "roi_align_backward", "route": "cuda",
         "source": "object_detection_tracking_tpu_torch/csrc/roi_align.cu",
         "replaces": "object_detection_tracking_tpu/ops/pallas/"
                     "roi_align_pallas.py:600",
         "launches": train["roi_align_backward_launches"],
         "max_abs_err": max(r["err_f32"] for r in list(bwd.values()) + list(
             quality["r18-mask"]["bwd"].values())
             + list(track_quality["bwd"].values())
             + list(so_train["bwd"].values())
             + list(parallel["bwd"].values())),
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
         "so_train_launches": so_train["launches"][
             "multilevel_roi_align_backward_cuda"],
         "so_train_per_launch": so_train["bwd"],
         "parallel_launches": parallel["roi_align_backward_launches"],
         "parallel_per_launch": parallel["bwd"],
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
                   "step's one (track_quality_per_launch), and phase "
                   "19's data-parallel step's two (parallel_per_launch)"},
        {"name": "bottleneck_stage", "route": "cuda",
         "source": "object_detection_tracking_tpu_torch/csrc/"
                   "bottleneck_stage.cu",
         "replaces": "object_detection_tracking_tpu/ops/pallas/"
                     "resnet_stage_pallas.py:155",
         "launches": actev["stage_launches"], "max_abs_err": stage_err,
         "tmot_launches": tmot["stage_launches"],
         "imgs_launches": imgs["default"]["stage_launches"],
         "imgs_options_launches": imgs["options"]["stage_launches"],
         "imgs_conv_head_launches": imgs["conv_head"]["stage_launches"],
         "ckpt_launches": ckpt["stage_launches"],
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
        ] + [effdet_kernel_row(name, effdet, kres) for name in ("d0", "d6")]
        + [so_box_grad_row(so_train, box_grad_synthetic),
           nms_kernel_row(main_res, actev, train, effdet, so, pack,
                          nms_synthetic)],
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
        "reid": reid,
        "imgs": {k: v for k, v in imgs.items()
                 if k not in ("check", "options_check", "extract_box_feat")},
        "small_objects": {k: v for k, v in so.items() if k != "roi"},
        "so_train": {k: v for k, v in so_train.items()
                     if k not in ("roi", "bwd", "box_grad")},
        "ckpt": {k: v for k, v in ckpt.items() if k != "check"},
        "parallel": {k: v for k, v in parallel.items()
                     if k not in ("roi", "bwd")},
        "pack": pack,
        "card": card}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
