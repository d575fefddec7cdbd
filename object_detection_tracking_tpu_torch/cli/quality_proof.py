"""End-to-end detection-quality proof of the port: render -> train -> eval
-> gate (port of object_detection_tracking_tpu/cli/quality_proof.py).

One command trains a detector from scratch on the synthetic shapes scenes
(``data/synthetic_np.py``: the file writer's scenes, rendered in memory
with numpy, no image codec and no cv2), through the port's train loop
(``cli/main.py build_config``, ``build_model``, ``train``), evaluates the
final checkpoint with ``run_eval`` and, with ``--add_mask``, the mean
full-image mask IOU of matched detections, and writes a JSON artifact. It
exits 1 when AP@0.5 (or the mask IOU) misses its gate.

The flags and defaults are the JAX package's, plus ``--device`` (default
cuda; with no GPU it raises unless ``--device cpu`` is given). In float32
on a GPU, TF32 is off for cuDNN and matmul. ``--video_domain`` trains the
tracking proof's detector on JAX's recipe: half the training scenes are
frames sampled from moving-shapes clips, the rest stills, and the
validation scenes are clip frames; the clips are rendered losslessly in
memory, where JAX's went through mp4 (ROADMAP C12).

Usage:
  python -m object_detection_tracking_tpu_torch.cli.quality_proof \\
      --hard --train_images 800 --steps 5000 \\
      --out_json TORCH_QUALITY_R18.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..utils.source_hash import quality_tree_hash

# the JAX artifact each run answers to, named only: the proof reads no file
# of the JAX package
JAX_REFERENCE = {"rcnn": "QUALITY_r05.json", "mask": "QUALITY_MASK_r05.json",
                 "efficientdet": "QUALITY_EFFDET_r05.json"}
RENDERER = "numpy, lossless (no JPEG); ROADMAP C11"
# --video_domain: JAX's video-domain detector has no committed artifact of
# its own; its AP is printed by the tracking proof it feeds
RENDERER_VIDEO = "numpy, lossless (no JPEG, no mp4); ROADMAP C11, C12"
JAX_REFERENCE_VIDEO = "TRACK_QUALITY_r05.json (its detector phase)"


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None,
                   help="run directory and checkpoints; default a new "
                        "temporary directory, so that no two runs share one")
    p.add_argument("--train_images", type=int, default=400)
    p.add_argument("--val_images", type=int, default=64)
    p.add_argument("--image_size", type=int, default=160)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--init_lr", type=float, default=None,
                   help="default 0.01 (momentum, rcnn) / 1e-3 (adam, "
                        "efficientdet)")
    p.add_argument("--min_ap", type=float, default=0.8)
    p.add_argument("--add_mask", action="store_true",
                   help="also train the Mask-RCNN head and gate on mean "
                   "full-image mask IOU over matched val detections")
    p.add_argument("--min_mask_iou", type=float, default=0.6)
    p.add_argument("--out_json", default=None,
                   help="default <workdir>/QUALITY.json")
    p.add_argument("--hard", action="store_true",
                   help="hard scene statistics: 4x+ scale spread, crowded "
                        "spawns, partial occlusion, 8 objects max")
    p.add_argument("--video_domain", action="store_true",
                   help="train on frames of moving-shapes clips mixed with "
                        "stills and evaluate on clip frames (the tracking "
                        "proof's domain); box-level gt, so not with "
                        "--add_mask")
    p.add_argument("--detector", default="rcnn",
                   help="'rcnn' (R18-FPN) or an efficientdet name "
                        "(e.g. efficientdet-d0)")
    p.add_argument("--optimizer", default=None,
                   help="override the train driver's optimizer "
                        "(efficientdet defaults to adam)")
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:N | cpu (no silent CPU fallback)")
    return p.parse_args(argv)


def train_flags(args) -> list:
    """The train CLI's flags for the proof (the JAX proof's list, with the
    port's --device; no lst, frame or annotation paths: the scenes come
    from memory)."""
    is_effdet = args.detector.startswith("efficientdet")
    steps_per_epoch = max(1, args.train_images // args.batch_size)
    epochs = max(1, -(-args.steps // steps_per_epoch))
    run_name = ("quality_effdet" if is_effdet else "quality_r18") + \
        ("_vid" if args.video_domain else "")
    return [
        "train",
        "--outbasepath", os.path.join(args.workdir, "runs"),
        "--modelname", run_name,
        "--version", "2",
        "--num_class", "16",
        "--short_edge_size", str(args.image_size),
        "--max_size", str(args.image_size),
        "--compute_dtype", "float32",
        "--freeze", "-1",
        "--num_epochs", str(epochs),
        "--im_batch_size", str(args.batch_size),
        "--init_lr", str(args.init_lr if args.init_lr is not None
                         else (1e-3 if is_effdet else 0.01)),
        "--warmup_steps", "100",
        "--clip_gradient_norm", "10",
        "--save_every", str(args.steps),
        "--eval_every", str(10 * args.steps),  # eval once, below
        "--device", args.device,
    ] + (["--add_mask"] if args.add_mask else []) \
      + (["--optimizer", args.optimizer or "adam"] if is_effdet
         else (["--optimizer", args.optimizer] if args.optimizer else []))


def proof_config(args, train_args, device):
    """The train configuration: the flags', then R18 with the RPN's train
    top-k at 512, or the EfficientDet named by --detector at the next
    multiple of 128 covering the scenes."""
    from . import main as driver
    cfg = driver.build_config(train_args, True, device)
    if args.detector.startswith("efficientdet"):
        # square EffDet input: next multiple of 128 covering the scenes
        # (the anchor grid assumes ceil-div level sizes, true at k*128)
        eff_size = -(-args.image_size // 128) * 128
        return dataclasses.replace(
            cfg, model="efficientdet", efficientdet_name=args.detector,
            efficientdet_image_size=eff_size, result_score_thres=0.05)
    return dataclasses.replace(cfg, resnet_depth=18,
                               rpn_train_pre_nms_topk=512,
                               rpn_train_post_nms_topk=512)


def hard_size_range(image_size: int):
    """The hard mode's object sizes: a 4x+ spread for scenes and clips."""
    return (max(image_size // 16, 8), image_size // 3)


def scene_kwargs(args) -> dict:
    if not args.hard:
        return {}
    return dict(size_range=hard_size_range(args.image_size),
                crowding=0.35, overlap_iou=0.45, max_objects=8)


def render_scenes(args):
    """The (train, val) scenes of JAX's proof for these flags. With
    ``--video_domain``: ``train_images // 2`` frames of 24-frame clips
    (every 3rd, prefix ``trv``, seed 0), then the rest as stills (prefix
    ``tr``, seed 1, normal statistics); the val scenes from 12-frame clips
    (every 6th, prefix ``va``, seed 777); ``--hard`` widens the clips'
    size range."""
    from ..data.synthetic_np import generate_dataset, generate_video_dataset
    hw = (args.image_size, args.image_size)
    if not args.video_domain:
        kw = scene_kwargs(args)
        return (generate_dataset(args.train_images, image_hw=hw, seed=0,
                                 prefix="tr", **kw),
                generate_dataset(args.val_images, image_hw=hw, seed=777,
                                 prefix="va", **kw))
    if args.add_mask:
        raise ValueError("--video_domain has box-level gt only: no "
                         "--add_mask")
    kw = (dict(size_range=hard_size_range(args.image_size)) if args.hard
          else {})
    n_vid = args.train_images // 2
    train = generate_video_dataset(
        n_vid, image_hw=hw, seed=0, prefix="trv", frames_per_video=24,
        sample_every=3, **kw) + generate_dataset(
        args.train_images - n_vid, image_hw=hw, seed=1, prefix="tr")
    val = generate_video_dataset(
        args.val_images, image_hw=hw, seed=777, prefix="va",
        frames_per_video=12, sample_every=6, **kw)
    return train, val


class StepClock:
    """A dataset's ``batches()`` with the wall time at which the train loop
    takes each batch of its first pass: the loop reads each step's loss on
    the host, so the gaps are the steps' times."""

    def __init__(self, ds):
        self.ds = ds
        self.num_samples = ds.num_samples
        self.stamps = None

    def batches(self, epochs: int = 1, **kwargs):
        stamps = []
        if self.stamps is None:
            self.stamps = stamps
        for batch in self.ds.batches(epochs, **kwargs):
            stamps.append(time.perf_counter())
            yield batch

    def step_ms_median(self):
        gaps = np.diff(self.stamps or [])
        return round(float(np.median(gaps)) * 1e3, 2) if len(gaps) else None


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or cpu."""
    if device.type != "cuda":
        return "cpu"
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return line or torch.cuda.get_device_name(device)


def launch_counts():
    """Each kernel wrapper's launch count so far."""
    from ..ops import resnet_stage as RS
    from ..ops import roi_align as RA
    return {fn.__name__: fn.launches for fn in (
        RA.multilevel_roi_align_cuda, RA.multilevel_roi_align_backward_cuda,
        RS.fused_bottleneck_stage_cuda)}


def launches_since(before):
    return {k: v - before[k] for k, v in launch_counts().items()}


def run(args):
    """Render, train, evaluate; returns the artifact's fields and the total
    loss of every step."""
    from ..data.synthetic_np import MemoryDetectionDataset
    from . import main as driver
    from .obj_detect_tracking import resolve_device

    device = resolve_device(args.device)
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="odt_quality_")
    if device.type == "cuda":
        # float32 means float32: no TF32 in cuDNN convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.time()
    train_scenes, val_scenes = render_scenes(args)
    print(f"rendered {args.train_images}+{args.val_images} images "
          f"in {time.time() - t0:.1f}s")

    is_effdet = args.detector.startswith("efficientdet")
    train_args = driver.get_args(train_flags(args))
    cfg = proof_config(args, train_args, device)
    model = driver.build_model(train_args, cfg, device)
    ds = StepClock(MemoryDetectionDataset(
        train_scenes, cfg.classname2id, cfg.short_edge_size, cfg.max_size,
        **driver.train_dataset_kwargs(train_args, cfg)))
    before = launch_counts()
    t_train = time.time()
    res = driver.train(train_args, cfg, model, ds)
    train_seconds = time.time() - t_train
    train_launches = launches_since(before)

    # evaluate the final checkpoint
    ckpt = driver.latest_ckpt(driver.checkpoint_dir(train_args))
    if not ckpt:
        raise RuntimeError("training produced no checkpoint")
    step = driver.load_ckpt(ckpt, res["trainer"])
    # the JAX proof evaluates with max_gt 8, one image a batch
    val_ds = MemoryDetectionDataset(
        val_scenes, cfg.classname2id, cfg.short_edge_size, cfg.max_size,
        batch_size=1, max_gt=8, shuffle=False, flip_prob=0.0)
    before = launch_counts()
    ap = driver.run_eval(train_args, cfg, model, dataset=val_ds)
    eval_launches = launches_since(before)

    mask_iou = None
    if args.add_mask:
        before = launch_counts()
        mask_iou = eval_mask_iou(cfg, model, val_scenes)
        eval_launches["mask_iou"] = launches_since(before)
        print(f"mean matched mask IOU: {mask_iou:.4f}")

    # the port's RPN top-k is exact at any rpn_topk_recall (ROADMAP C3),
    # so the JAX proof's second, exact-top-k eval would repeat this one
    ap_exact = None if is_effdet or cfg.rpn_topk_recall >= 1.0 else ap
    losses = res["losses"]
    kind = ("efficientdet" if is_effdet else
            "mask" if args.add_mask else "rcnn")
    return {
        "ap50": round(float(ap), 4),
        "ap50_exact_topk": (None if ap_exact is None
                            else round(float(ap_exact), 4)),
        "ap50_exact_topk_note": (
            None if ap_exact is None else
            "the port's RPN top-k is always exact (ROADMAP C3): ap50 is "
            "already the exact-top-k AP"),
        "rpn_topk_recall": cfg.rpn_topk_recall,
        "min_ap": args.min_ap,
        "passed": bool(ap >= args.min_ap and
                       (mask_iou is None or mask_iou >= args.min_mask_iou)),
        "trained_steps": int(step),
        "train_images": args.train_images,
        "val_images": args.val_images,
        "image_size": args.image_size,
        "hard": args.hard,
        "video_domain": args.video_domain,
        "mask_iou": None if mask_iou is None else round(mask_iou, 4),
        "min_mask_iou": args.min_mask_iou if args.add_mask else None,
        "model": (args.detector + " (from scratch, synthetic shapes)"
                  if is_effdet else
                  "R18-FPN %s (from scratch, synthetic shapes)"
                  % ("MaskRCNN" if args.add_mask else "FasterRCNN")),
        "wall_seconds": round(time.time() - t0, 1),
        "train_seconds": round(train_seconds, 1),
        "step_ms_median": ds.step_ms_median(),
        "train_loss": {"first10": round(float(np.mean(losses[:10])), 4),
                       "last10": round(float(np.mean(losses[-10:])), 4)},
        "kernel_launches": {"train": train_launches, "eval": eval_launches},
        "device": card_name(device),
        "torch": torch.__version__,
        "compute_dtype": cfg.compute_dtype,
        "tf32": False,
        "renderer": RENDERER_VIDEO if args.video_domain else RENDERER,
        "jax_reference": (JAX_REFERENCE_VIDEO if args.video_domain
                          else JAX_REFERENCE[kind]),
        "tree_hash": quality_tree_hash(),
    }, losses


def eval_mask_iou(cfg, model, scenes, score_thres: float = 0.5,
                  match_iou: float = 0.5) -> float:
    """Mean full-image mask IOU over box-matched val detections: the
    predicted 28x28 mask and the gt box-local mask, both pasted onto the
    image canvas by ``fill_full_mask`` (0.5 threshold), through the
    ``DetectionRunner`` at depth 1 on an inference copy of ``model``."""
    from ..models import get_model
    from ..runtime import DetectionRunner
    from ..utils.masks import fill_full_mask

    infer = get_model(dataclasses.replace(cfg, is_train=False)).to(
        model.device).eval()
    infer.load_state_dict(model.state_dict())
    runner = DetectionRunner(infer, depth=1)
    ious = []
    for host, scene in runner.run((s.image[None], s) for s in scenes):
        gt_boxes = np.asarray(scene.anno["boxes"], np.float32).reshape(-1, 4)
        gt_masks = np.asarray(scene.anno["masks"], np.float32)
        hw = scene.image.shape[:2]
        valid = host["final_valid"][0] & (host["final_probs"][0]
                                          >= score_thres)
        for i in np.flatnonzero(valid):
            box = host["final_boxes"][0][i]
            # best-IOU gt
            x1 = np.maximum(box[0], gt_boxes[:, 0])
            y1 = np.maximum(box[1], gt_boxes[:, 1])
            x2 = np.minimum(box[2], gt_boxes[:, 2])
            y2 = np.minimum(box[3], gt_boxes[:, 3])
            inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
            area_p = (box[2] - box[0]) * (box[3] - box[1])
            area_g = (gt_boxes[:, 2] - gt_boxes[:, 0]) * \
                (gt_boxes[:, 3] - gt_boxes[:, 1])
            bious = inter / np.maximum(area_p + area_g - inter, 1e-9)
            j = int(bious.argmax()) if len(bious) else -1
            if j < 0 or bious[j] < match_iou:
                continue
            pred_full = fill_full_mask(box, host["final_masks"][0][i], hw)
            gt_full = fill_full_mask(gt_boxes[j], gt_masks[j], hw)
            u = np.logical_or(pred_full, gt_full).sum()
            if u:
                ious.append(np.logical_and(pred_full, gt_full).sum() / u)
    return float(np.mean(ious)) if ious else 0.0


def main(argv=None):
    args = get_args(argv)
    out, _ = run(args)
    out_path = args.out_json or os.path.join(args.workdir, "QUALITY.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    if not out["passed"]:
        print(f"FAIL: AP {out['ap50']:.4f} < {args.min_ap}"
              + ("" if out["mask_iou"] is None else
                 f" or mask IOU {out['mask_iou']:.4f} < "
                 f"{args.min_mask_iou}"), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
