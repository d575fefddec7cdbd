"""End-to-end detection and tracking quality proof of the port: train ->
track -> score (port of object_detection_tracking_tpu/cli/
track_quality_proof.py).

A from-scratch R18-FPN shapes detector, trained on the video domain by the
port's ``quality_proof --video_domain``, drives Deep SORT or TMOT over a
synthetic moving-shapes video through the port's ``process_video``, and the
MOT tracks are scored per class against the generator's ground truth with
CLEAR-MOT and IDF1 (``evaluation_mot.py``). It exits 1 when MOTA, IDF1 or a
class's MOTA misses its gate.

The flags and defaults are the JAX package's, plus ``--device`` (default
cuda; with no GPU it raises unless ``--device cpu`` is given). The video is
rendered in memory (``data/synthetic_np.py generate_video``: the frames
JAX hands its mp4 writer, bit for bit) and read by ``process_video``
through a ``MemoryVideo``, in BGR: no codec and no cv2 on the path, where
JAX's proof reads the mp4 back and ships I420 (ROADMAP C12). In float32 on
a GPU, TF32 is off for cuDNN and matmul.

Usage:
  python -m object_detection_tracking_tpu_torch.cli.track_quality_proof \\
      --workdir /tmp/track_quality --hard --steps 4000 \\
      --min_mota 0.6 --min_class_mota 0.6
If <workdir>/runs/quality_r18_vid/save already holds a checkpoint (e.g.
from the other tracker's run in the same workdir), training is skipped.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

from ..utils.source_hash import quality_tree_hash

JAX_REFERENCE = "TRACK_QUALITY_r05.json"
RENDERER = ("numpy, lossless, in memory (no mp4): the frames fed to "
            "process_video by a MemoryVideo; ROADMAP C12")
PIXEL_FORMAT = "bgr"
RUN_NAME = "quality_r18_vid"
VIDEO_NAME = "track_video"


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", default=None,
                   help="run directory and checkpoints; default a new "
                        "temporary directory, so that no two runs share one")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--image_size", type=int, default=160)
    p.add_argument("--num_frames", type=int, default=150)
    p.add_argument("--num_objects", type=int, default=4)
    p.add_argument("--min_confidence", type=float, default=0.7,
                   help="0.7 suppresses the from-scratch detector's "
                        "cross-class duplicate detections")
    p.add_argument("--min_mota", type=float, default=0.5)
    p.add_argument("--min_idf1", type=float, default=0.7)
    p.add_argument("--min_class_mota", type=float, default=0.5,
                   help="per-class MOTA floor: every class is gated, not "
                        "only the aggregate")
    p.add_argument("--min_class_idf1", type=float, default=None)
    p.add_argument("--hard", action="store_true",
                   help="hard generator: a 4x+ scale spread, constant "
                        "path crossings and occlusions; also trains the "
                        "detector on hard clips")
    p.add_argument("--min_ap", type=float, default=0.8,
                   help="detection gate forwarded to quality_proof")
    p.add_argument("--tracker", default="deep_sort",
                   choices=["deep_sort", "tmot"])
    p.add_argument("--emb_max_dist", type=float, default=1.0,
                   help="tmot stage-1 fused-distance threshold (the JDE "
                        "default 0.7 is tuned for trained ReID embeddings; "
                        "the from-scratch detector's are noisier)")
    p.add_argument("--out_json", default=None,
                   help="default <workdir>/TRACK_QUALITY.json")
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:N | cpu (no silent CPU fallback)")
    return p.parse_args(argv)


def detector_config(args, device):
    """(train flags, inference config) of the detector the video-domain
    proof trains: the flags' v2 config at 160 px in float32, with R18."""
    from . import main as driver
    train_args = driver.get_args([
        "train", "--outbasepath", os.path.join(args.workdir, "runs"),
        "--modelname", RUN_NAME, "--version", "2", "--num_class", "16",
        "--short_edge_size", str(args.image_size),
        "--max_size", str(args.image_size), "--compute_dtype", "float32",
        "--device", args.device])
    cfg = driver.build_config(train_args, False, device)
    return train_args, dataclasses.replace(cfg, resnet_depth=18)


def load_detector(args, device):
    """(config, inference model with the latest checkpoint's weights, its
    step)."""
    from . import main as driver
    from ..models import get_model
    train_args, cfg = detector_config(args, device)
    ckpt = driver.latest_ckpt(driver.checkpoint_dir(train_args))
    if not ckpt:
        raise RuntimeError("no checkpoint found after training")
    state = torch.load(ckpt, map_location=device)
    model = get_model(cfg).to(device).eval()
    model.load_state_dict(state["params"])
    return cfg, model, int(state["step"])


def tracker_flags(args, classes, tracking_dir, link, n_init, max_iou,
                  nn_budget):
    """The video CLI's flags for one tracking pass over the proof video:
    every frame (gap 1), B=8, BGR, the tracker's knobs."""
    return (["--video_dir", args.workdir, "--video_lst_file", os.devnull,
             "--tracking_objs", ",".join(classes), "--tracker", args.tracker,
             "--get_tracking", "--frame_gap", "1", "--im_batch_size", "8",
             "--prefetch", "5", "--pixel_format", PIXEL_FORMAT,
             "--tracking_dir", tracking_dir, "--nms_max_overlap", "0.85",
             "--min_confidence", str(args.min_confidence),
             "--min_detection_height", "0", "--max_cosine_distance", "0.5",
             "--nn_budget", str(nn_budget),
             "--max_iou_distance", str(max_iou),
             "--track_n_init", str(n_init),
             "--track_max_second_lost", "4.0",
             "--emb_max_dist", str(args.emb_max_dist), "--device",
             args.device]
            + ([] if link is None else ["--link_tracklets", str(link)]))


def score_tracks(gt, classes, tracking_dir, videoname=VIDEO_NAME):
    """CLEAR-MOT and IDF1 of each class's MOT file against the generator's
    ground truth, and their sums over the classes: returns (MOTA, IDF1,
    MOTP, totals, per-class metrics). A class with no file scores as no
    hypotheses."""
    from ..evaluation_mot import evaluate_tracks, load_mot_txt
    totals = dict(fn=0, fp=0, idsw=0, n_gt=0, idtp=0, idfp=0, idfn=0)
    iou_weighted = 0.0
    n_match = 0
    per_class = {}
    for cls in classes:
        gt_c = {t: [(tid, box) for tid, box, c in fr if c == cls]
                for t, fr in gt.items()}
        txt = os.path.join(tracking_dir, videoname, cls, f"{videoname}.txt")
        hyp_c = load_mot_txt(txt) if os.path.exists(txt) else {}
        m = evaluate_tracks(gt_c, hyp_c)
        per_class[cls] = {k: round(float(v), 4) for k, v in m.items()}
        for k in totals:
            totals[k] += m[k]
        iou_weighted += m["motp"] * m["n_matches"]
        n_match += m["n_matches"]
    mota = 1.0 - (totals["fn"] + totals["fp"] + totals["idsw"]) / \
        max(totals["n_gt"], 1)
    idf1 = 2.0 * totals["idtp"] / \
        max(2 * totals["idtp"] + totals["idfp"] + totals["idfn"], 1)
    motp = iou_weighted / max(n_match, 1)
    return mota, idf1, motp, totals, per_class


def run(args):
    """Train (or reuse) the detector, render the video, track it twice
    (tuned, reference parity) and score; returns the artifact's fields."""
    from . import obj_detect_tracking as odt
    from . import quality_proof
    from . import main as driver
    from ..data.synthetic_np import generate_video
    from ..runtime import DetectionRunner

    device = odt.resolve_device(args.device)
    if args.workdir is None:
        args.workdir = tempfile.mkdtemp(prefix="odt_track_quality_")
    if device.type == "cuda":
        # float32 means float32: no TF32 in cuDNN convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()

    train_args, _ = detector_config(args, device)
    ckpt_dir = driver.checkpoint_dir(train_args)
    detector_json = os.path.join(args.workdir, "QUALITY.json")
    trained_here = not driver.latest_ckpt(ckpt_dir)
    if trained_here:
        print("== phase 1: training the shapes detector (quality_proof) ==")
        quality_proof.main([
            "--workdir", args.workdir, "--steps", str(args.steps),
            "--image_size", str(args.image_size), "--video_domain",
            "--min_ap", str(args.min_ap), "--device", args.device,
            "--out_json", detector_json]
            + (["--hard"] if args.hard else []))
    else:
        print(f"== phase 1: reusing trained detector in {ckpt_dir} ==")
    # the detector's own artifact, from this run or the one that trained
    # it in this workdir
    detector, detector_launches = {"trained_here": trained_here}, None
    if os.path.exists(detector_json):
        with open(detector_json) as f:
            q = json.load(f)
        detector.update({k: q[k] for k in (
            "ap50", "min_ap", "trained_steps", "train_images", "val_images",
            "step_ms_median", "train_seconds", "wall_seconds",
            "tree_hash")})
        detector_launches = q["kernel_launches"]
    cfg, model, trained_steps = load_detector(args, device)

    print("== phase 2: rendering the moving-shapes video ==")
    video, gt = generate_video(
        num_frames=args.num_frames,
        image_hw=(args.image_size, args.image_size),
        num_objects=args.num_objects, seed=123,
        size_range=(quality_proof.hard_size_range(args.image_size)
                    if args.hard else None))

    print("== phase 3: det+track through the port's video path ==")
    runner = DetectionRunner(model)
    classes = sorted({c for fr in gt.values() for _, _, c in fr})
    launches = {}

    def track_and_score(name, **knobs):
        tracking_dir = os.path.join(args.workdir, name)
        odt_args = odt.get_args(tracker_flags(args, classes, tracking_dir,
                                              **knobs))
        video.seek(0)
        before = quality_proof.launch_counts()
        n = odt.process_video(odt_args, cfg, runner, VIDEO_NAME + ".mp4",
                              cfg.classid2name, None, vcap=video)
        launches[name] = quality_proof.launches_since(before)
        if n != args.num_frames:
            raise RuntimeError(f"processed {n}/{args.num_frames} frames")
        return score_tracks(gt, classes, tracking_dir)

    # tuned: nn_budget 40, max_iou_distance 0.6, n_init 3, offline tracklet
    # linking at 0.2 (the JAX proof's knobs, each one the reference exposes)
    print("== phase 4: CLEAR-MOT / IDF1 vs generator ground truth ==")
    mota, idf1_all, motp, totals, per_class = track_and_score(
        "tracks", link=0.2, n_init=3, max_iou=0.6, nn_budget=40)
    # reference parity: the reference's own defaults, recorded beside the
    # tuned numbers; the gates read the tuned ones
    r_mota, r_idf1, r_motp, _, r_per_class = track_and_score(
        "tracks_refparity", link=None, n_init=1, max_iou=0.5, nn_budget=5)
    print(f"reference-parity (unlinked, n_init=1): MOTA {r_mota:.3f} "
          f"IDF1 {r_idf1:.3f} (tuned: {mota:.3f}/{idf1_all:.3f})")

    class_gates_ok = all(
        (args.min_class_mota is None or m["mota"] >= args.min_class_mota)
        and (args.min_class_idf1 is None or m["idf1"] >= args.min_class_idf1)
        for m in per_class.values())
    return {
        "mota": round(mota, 4),
        "idf1": round(idf1_all, 4),
        "motp": round(motp, 4),
        "idsw": totals["idsw"],
        "fn": totals["fn"], "fp": totals["fp"], "n_gt": totals["n_gt"],
        "min_mota": args.min_mota, "min_idf1": args.min_idf1,
        "passed": bool(mota >= args.min_mota and
                       idf1_all >= args.min_idf1 and class_gates_ok),
        "min_class_mota": args.min_class_mota,
        "min_class_idf1": args.min_class_idf1,
        "hard": args.hard,
        "per_class": per_class,
        "reference_parity": {
            "mota": round(r_mota, 4), "idf1": round(r_idf1, 4),
            "motp": round(r_motp, 4),
            "per_class": r_per_class,
            "config": "n_init=1, max_iou_distance=0.5, nn_budget=5, "
                      "no offline linking (reference defaults, "
                      "deep_sort/tracker.py:40 + "
                      "obj_detect_tracking.py:176)",
        },
        "tracker": args.tracker,
        "num_frames": args.num_frames,
        "num_objects": args.num_objects,
        "trained_steps": trained_steps,
        "model": "R18-FPN FasterRCNN (from scratch, synthetic shapes) "
                 "+ " + args.tracker,
        "wall_seconds": round(time.time() - t0, 1),
        "detector": detector,
        "kernel_launches": {"detector": detector_launches,
                            "tracking": launches},
        "device": quality_proof.card_name(device),
        "torch": torch.__version__,
        "compute_dtype": cfg.compute_dtype,
        "tf32": False,
        "renderer": RENDERER,
        "pixel_format": PIXEL_FORMAT,
        "jax_reference": JAX_REFERENCE,
        "tree_hash": quality_tree_hash(),
    }


def main(argv=None):
    args = get_args(argv)
    out = run(args)
    out_path = args.out_json or os.path.join(args.workdir,
                                             "TRACK_QUALITY.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    if not out["passed"]:
        print(f"FAIL: MOTA {out['mota']:.3f} (min {args.min_mota}) "
              f"IDF1 {out['idf1']:.3f} (min {args.min_idf1})",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
