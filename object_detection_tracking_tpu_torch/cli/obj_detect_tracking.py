"""Video object detection + tracking CLI (port of
object_detection_tracking_tpu/cli/obj_detect_tracking.py:40-451).

Per video: decode -> resize on a host thread, the batched detector on the
GPU with pipelined transfers, Deep SORT or TMOT (``--tracker tmot``, the
JDE tracker) per tracked class on the host;
writes per-frame detection JSON and MOT-format track txt in the JAX CLI's
formats. Same flags as the JAX CLI, plus ``--device`` (default cuda; with
no GPU it raises unless ``--device cpu`` is given). ``--compute_dtype``
defaults to bfloat16 on the GPU and float32 on the CPU. The architecture
toggles (``ARCH_TOGGLES``: --use_gn, --use_deformable,
--use_conv_frcnn_head, --use_att_frcnn_head, --add_relation_nn and the
rest) layer over --version as in JAX. ``--model_path`` takes what the JAX
CLI takes (utils/weights.py load_weights): a TF V2 checkpoint of the
reference (a directory, a prefix or its ``.index``), a tensorpack-named
``.npz``, the native flat ``.npz``, and for EfficientDet automl ``.npz``
files and bundles. ``--use_lijun_video_loader`` decodes with PyAV and
raises where ``av`` does not import; ``--log_time_and_gpu`` samples host
CPU, RSS and the card's allocated memory (runtime/profiler.py) and
``--save_util_log_to`` writes the series as JSON.

Example:
  python -m object_detection_tracking_tpu_torch.cli.obj_detect_tracking \
    --video_dir videos --video_lst_file videos.lst \
    --model_path model.npz --use_partial_classes --resnet50 \
    --short_edge_size 720 --max_size 1280 --frame_gap 8 --im_batch_size 8 \
    --get_tracking --tracking_dir tracks_out --device cuda

``--is_efficientdet`` runs EfficientDet (``--efficientdet_modelname``,
d0 by default) on frames fitted into its square input.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from ..class_ids import coco_obj_to_actev_obj, targetAct2id
from ..config import DetectorConfig
from ..data import VideoEnqueuer, open_video
from ..data import video as video_io
from ..models import get_model
from ..params import init_params, params_from_jax
from ..runtime import DetectionRunner, PerformanceLogger
from ..tracking.deep_sort import (Tracker, create_obj_infos, det_level_nms,
                                  filter_short_objs, linear_inter_bbox,
                                  link_tracklets)
from ..tracking.deep_sort.nn_matching import NearestNeighborDistanceMetric
from ..tracking.tmot import JDETracker
from ..utils.masks import fill_full_mask, rle_encode
from ..utils.weights import load_weights

# --log_time_and_gpu's sampling period in seconds (JAX CLI :433)
PERF_INTERVAL = 5.0

# the architecture toggles layered over --version (DetectorConfig fields),
# the same in this CLI and in cli/obj_detect_imgs.py (JAX
# obj_detect_tracking.py:165-168, obj_detect_imgs.py:51-55)
ARCH_TOGGLES = ("use_dilations", "use_deformable", "use_se", "use_resnext",
                "use_gn", "use_frcnn_class_agnostic", "use_att_frcnn_head",
                "use_conv_frcnn_head", "add_relation_nn")


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--video_dir", required=True)
    parser.add_argument("--video_lst_file", required=True,
                        help="one video filename per line")
    parser.add_argument("--out_dir", default=None,
                        help="per-frame detection json output dir")
    parser.add_argument("--model_path", default=None,
                        help="a TF V2 checkpoint (directory, prefix or "
                        ".index), a tensorpack-named .npz or the native "
                        "flat .npz (EfficientDet: also automl names)")
    parser.add_argument("--version", type=int, default=4)
    parser.add_argument("--num_class", type=int, default=16)
    parser.add_argument("--is_coco_model", action="store_true")
    parser.add_argument("--use_partial_classes", action="store_true")
    parser.add_argument("--actasobj", action="store_true",
                        help="use the activity-box taxonomy "
                        "(class_ids.targetAct2id)")
    parser.add_argument("--is_efficientdet", action="store_true")
    parser.add_argument("--efficientdet_modelname", default="efficientdet-d0")
    parser.add_argument("--efficientdet_max_detection_topk", type=int,
                        default=5000)
    parser.add_argument("--resnet18", action="store_true")
    parser.add_argument("--resnet34", action="store_true")
    parser.add_argument("--resnet50", action="store_true")
    parser.add_argument("--resnet152", action="store_true")
    # explicit architecture toggles on top of --version presets
    # (ref obj_detect_tracking.py:134-228); None = keep preset value
    for flag in ARCH_TOGGLES:
        parser.add_argument("--" + flag, action="store_true", default=None)
    parser.add_argument("--rpn_test_post_nms_topk", type=int, default=None)
    parser.add_argument("--max_size", type=int, default=1920)
    parser.add_argument("--short_edge_size", type=int, default=1080)
    parser.add_argument("--frame_gap", type=int, default=8)
    parser.add_argument("--im_batch_size", type=int, default=1)
    parser.add_argument("--threshold_conf", type=float, default=0.0001)
    parser.add_argument("--compute_dtype", default=None,
                        help="bfloat16 | float32; default bfloat16 on the "
                        "GPU, float32 on the CPU")
    parser.add_argument("--device", default="cuda",
                        help="cuda | cuda:N | cpu (no silent CPU fallback)")
    parser.add_argument("--add_mask", action="store_true",
                        help="Mask-RCNN head: per-detection RLE "
                        "segmentation in the frame json")
    parser.add_argument("--get_box_feat", action="store_true",
                        help="dump per-frame [N,7,7,C] ROI features "
                        "(bf16-rounded) as box_feat_path/<video>/<frame>"
                        ".npy (ref obj_detect_tracking.py:612-622)")
    parser.add_argument("--box_feat_path", default=None)
    # tracking
    parser.add_argument("--get_tracking", action="store_true")
    parser.add_argument("--tracker", default="deep_sort",
                        choices=["deep_sort", "tmot"],
                        help="tmot = the JDE tracker (tracking/tmot)")
    parser.add_argument("--track_max_second_lost", type=float, default=4.0)
    parser.add_argument("--emb_max_dist", type=float, default=0.7)
    parser.add_argument("--emb_agg_method", default="average",
                        choices=["average", "avg", "max", "spatial"],
                        help="7x7 ROI-feature aggregation for tracking "
                        "embeddings (reference tmot CLI :514-525)")
    parser.add_argument("--tracking_dir", default="/tmp/tracking_dir")
    parser.add_argument("--tracking_objs", default="Person,Vehicle")
    parser.add_argument("--min_confidence", type=float, default=0.85)
    parser.add_argument("--min_detection_height", type=int, default=0)
    parser.add_argument("--max_cosine_distance", type=float, default=0.5)
    parser.add_argument("--max_iou_distance", type=float, default=0.5)
    parser.add_argument("--nn_budget", type=int, default=5)
    parser.add_argument("--track_n_init", type=int, default=1,
                        help="frames before a new track confirms "
                        "(reference hardcodes 1, deep_sort/tracker.py:40)")
    parser.add_argument("--nms_max_overlap", type=float, default=0.85)
    parser.add_argument("--link_tracklets", type=float, default=None,
                        help="offline tracklet linking: after the video, "
                        "merge track ids whose spans are temporally disjoint "
                        "and whose whole-life mean appearance is within "
                        "this cosine distance (off by default)")
    # misc
    parser.add_argument("--use_lijun_video_loader", action="store_true",
                        help="use the PyAV frame-accurate decoder "
                        "(raises without PyAV)")
    parser.add_argument("--log_time_and_gpu", action="store_true",
                        help="sample host CPU, RSS and device memory "
                        "while the videos run; print the summary")
    parser.add_argument("--save_util_log_to", default=None,
                        help="with --log_time_and_gpu: write the sampled "
                        "series here as JSON")
    parser.add_argument("--use_my_naming", action="store_true")
    parser.add_argument("--test_frame_extraction", action="store_true")
    parser.add_argument("--visualize", action="store_true",
                        help="write detection-drawn frames (forces bgr "
                        "pixel format)")
    parser.add_argument("--vis_path", default="/tmp/vis")
    parser.add_argument("--vis_thres", type=float, default=0.7)
    parser.add_argument("--prefetch", type=int, default=10)
    parser.add_argument("--pixel_format", default="auto",
                        choices=["auto", "bgr", "i420"],
                        help="i420 halves host->device bytes (device-side "
                        "color conversion, cv2-exact); auto picks i420 "
                        "when frame dims are even")
    args = parser.parse_args(argv)
    if args.use_lijun_video_loader and not video_io._HAS_AV:
        # no silent cv2 decode in its place (JAX data/video.py:268-270)
        raise RuntimeError("--use_lijun_video_loader needs PyAV, and av "
                           "does not import")
    return args


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA request without a GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but torch.cuda.is_available() is False; pass "
            "--device cpu to run on the CPU")
    return device


def build_config(args, device: torch.device) -> DetectorConfig:
    dtype = args.compute_dtype or (
        "bfloat16" if device.type == "cuda" else "float32")
    overrides = dict(
        num_class=args.num_class,
        short_edge_size=args.short_edge_size,
        max_size=args.max_size,
        result_score_thres=args.threshold_conf,
        compute_dtype=dtype,
        add_mask=args.add_mask,
        resnet_depth=50 if args.resnet50 else (
            152 if args.resnet152 else (
                18 if args.resnet18 else (34 if args.resnet34 else 101))),
    )
    for f in ARCH_TOGGLES + ("rpn_test_post_nms_topk",):
        v = getattr(args, f, None)
        if v is not None:
            overrides[f] = v
    if args.is_efficientdet:
        from ..models.efficientdet import EFFICIENTDET_CONFIGS
        size = EFFICIENTDET_CONFIGS[args.efficientdet_modelname][1]
        # fit into the square input: short edge = max size = image size
        # makes get_new_hw scale by image_size / max(h, w)
        overrides.update(
            short_edge_size=size, max_size=size,
            efficientdet_name=args.efficientdet_modelname,
            efficientdet_max_detection_topk=(
                args.efficientdet_max_detection_topk))
        overrides.pop("num_class", None)   # COCO models: 81 classes
        if args.use_partial_classes:
            return DetectorConfig.coco_partial(**overrides)
        return DetectorConfig.coco(**overrides)
    if args.use_partial_classes:
        overrides.pop("num_class", None)
        return DetectorConfig.coco_partial(**overrides)
    if args.is_coco_model:
        overrides.pop("num_class", None)
        return DetectorConfig.coco(**overrides)
    if args.actasobj:
        overrides.update(class_map="activity", num_class=len(targetAct2id))
    return DetectorConfig.from_version(args.version, **overrides)


def process_video(args, cfg, runner, video_path, classid2name,
                  coco_to_actev, vcap=None):
    """Detect and track one video; returns the number of frames processed.
    ``vcap``: an already open VideoReader to read instead of opening
    ``video_path`` (whose base name still names the outputs)."""
    videoname = os.path.splitext(os.path.basename(video_path))[0]
    if vcap is None:
        try:
            vcap = open_video(
                video_path,
                "pyav" if args.use_lijun_video_loader else "auto")
        except (IOError, RuntimeError) as e:
            print(f"warning: cannot open {video_path}: {e}", file=sys.stderr)
            return 0

    tracking_objs = args.tracking_objs.split(",")
    trackers = {}
    results = {}
    tentative_buf = {}
    for obj in tracking_objs:
        if args.tracker == "tmot":
            trackers[obj] = JDETracker(
                conf_thres=args.min_confidence,
                track_max_second_lost=args.track_max_second_lost,
                emb_max_dist=args.emb_max_dist,
                frame_gap=args.frame_gap)
        else:
            metric = NearestNeighborDistanceMetric(
                "cosine", args.max_cosine_distance, args.nn_budget)
            trackers[obj] = Tracker(
                metric, max_iou_distance=args.max_iou_distance,
                n_init=args.track_n_init)
        results[obj] = []
        tentative_buf[obj] = {}

    video_out_path = None
    if args.out_dir is not None:
        video_out_path = os.path.join(args.out_dir, videoname)
        os.makedirs(video_out_path, exist_ok=True)

    pixel_format = "bgr" if args.visualize else args.pixel_format
    enq = VideoEnqueuer(vcap, cfg.short_edge_size, cfg.max_size,
                        frame_gap=args.frame_gap,
                        batch_size=args.im_batch_size,
                        prefetch=args.prefetch, pad_last_batch=True,
                        pixel_format=pixel_format)

    if args.test_frame_extraction:
        # decode-only check: drain the enqueuer and compare the sampled
        # count against the container metadata
        n = 0
        for _, _, frame_idxs in enq.get():
            n += sum(1 for fi in frame_idxs if fi >= 0)
        print("video %s got %s frames, loader said frame count is %s"
              % (videoname, enq.frames_read, vcap.num_frames))
        return n

    def batch_iter():
        for imgs, scale, frame_idxs in enq.get():
            frames = imgs if args.visualize else None
            yield imgs, (scale, frame_idxs, frames)

    frames_done = 0
    vis_count = 0
    for host_out, (scale, frame_idxs, frames) in runner.run(batch_iter()):
        for bi, cur_frame in enumerate(frame_idxs):
            if cur_frame < 0:
                continue  # last-batch padding
            boxes = host_out["final_boxes"][bi]
            labels = host_out["final_labels"][bi]
            probs = host_out["final_probs"][bi]
            valid = host_out["final_valid"][bi]
            feats = host_out["pooled_box_feat"][bi]
            frames_done += 1

            if args.get_box_feat:
                feat_dir = os.path.join(args.box_feat_path, videoname)
                os.makedirs(feat_dir, exist_ok=True)
                np.save(os.path.join(feat_dir, "%d.npy" % cur_frame),
                        host_out["fpn_box_feat"][bi][valid])

            if args.get_tracking:
                for obj in tracking_objs:
                    dets = create_obj_infos(
                        boxes, labels, probs, feats, valid, classid2name,
                        obj, scale=scale,
                        min_confidence=args.min_confidence,
                        min_detection_height=args.min_detection_height,
                        coco_to_actev=coco_to_actev)
                    dets = det_level_nms(dets, args.nms_max_overlap)
                    tracker = trackers[obj]
                    if args.tracker == "tmot":
                        # TMOT writes the matched detection's own box
                        for t in tracker.update(
                                [(d.tlwh, d.confidence, d.feature)
                                 for d in dets]):
                            b = t.cur_det_tlwh
                            results[obj].append([cur_frame, t.track_id,
                                                 b[0], b[1], b[2], b[3]])
                    else:
                        tracker.predict()
                        tracker.update(dets)
                        _store_tracks(tracker, cur_frame, results[obj],
                                      tentative_buf[obj])

            if video_out_path is not None:
                masks = host_out.get("final_masks")
                _write_frame_json(args, video_out_path, videoname, cur_frame,
                                  boxes, labels, probs, valid, scale,
                                  classid2name,
                                  masks[bi] if masks is not None else None,
                                  enq.orig_hw)

            if args.visualize and frames is not None:
                import cv2
                from ..utils.viz import draw_boxes
                good = valid & (probs >= args.vis_thres)
                vis_boxes = boxes[good]
                vis_labels = ["%s_%.2f" % (classid2name.get(int(l), "?"), p)
                              for l, p in zip(labels[good], probs[good])]
                newim = draw_boxes(frames[bi], vis_boxes, vis_labels)
                os.makedirs(os.path.join(args.vis_path, videoname),
                            exist_ok=True)
                cv2.imwrite(os.path.join(
                    args.vis_path, videoname,
                    "%s_F_%08d.jpg" % (videoname, vis_count)), newim)
                vis_count += 1

    if args.get_tracking:
        for obj in tracking_objs:
            out_dir = os.path.join(args.tracking_dir, videoname, obj)
            os.makedirs(out_dir, exist_ok=True)
            rows = sorted(results[obj], key=lambda r: (r[0], r[1]))
            data = np.asarray(rows, np.float32).reshape(-1, 6)
            if args.link_tracklets is not None:
                data = link_tracklets(
                    data, trackers[obj].feature_archive(),
                    max_feat_dist=args.link_tracklets,
                    frame_gap=args.frame_gap)
            data = linear_inter_bbox(data, args.frame_gap)
            data = filter_short_objs(data)
            with open(os.path.join(out_dir, f"{videoname}.txt"), "w") as fw:
                for r in data.tolist():
                    fw.write("%d,%d,%.2f,%.2f,%.2f,%.2f,1,-1,-1,-1\n"
                             % (r[0], r[1], r[2], r[3], r[4], r[5]))

    return frames_done


def _store_tracks(tracker, cur_frame, rows, tent_buf):
    """Buffer tentative-track boxes; flush them once the track confirms
    (reference obj_detect_tracking.py:668-695)."""
    for track in tracker.tracks:
        if not track.is_confirmed() or track.time_since_update > 1:
            if (not track.is_confirmed()) and track.time_since_update == 0:
                b = track.to_tlwh()
                tent_buf.setdefault(track.track_id, []).append(
                    [cur_frame, track.track_id, b[0], b[1], b[2], b[3]])
            continue
        b = track.to_tlwh()
        if track.track_id in tent_buf:
            rows.extend(tent_buf.pop(track.track_id))
        rows.append([cur_frame, track.track_id, b[0], b[1], b[2], b[3]])


def _write_frame_json(args, video_out_path, videoname, cur_frame, boxes,
                      labels, probs, valid, scale, classid2name, masks=None,
                      orig_hw=None):
    """One frame's detections as JSON; with masks [R, 28, 28], each one's
    COCO RLE pasted into the original frame (JAX CLI :364-390)."""
    pred = []
    for i in np.flatnonzero(valid):
        box = boxes[i] / scale
        x, y = float(box[0]), float(box[1])
        w, h = float(box[2] - box[0]), float(box[3] - box[1])
        cat_id = int(labels[i])
        rle = None
        if masks is not None and orig_hw is not None:
            rle = rle_encode(fill_full_mask(box, masks[i], orig_hw))
        pred.append({
            "category_id": cat_id,
            "cat_name": classid2name.get(cat_id, str(cat_id)),
            "score": float(round(float(probs[i]), 7)),
            "bbox": [round(x, 2), round(y, 2), round(w, 2), round(h, 2)],
            "segmentation": rle,
        })
    if args.use_my_naming:
        name = "%s_F_%08d.json" % (videoname, cur_frame)
    else:
        name = "%d.json" % cur_frame
    with open(os.path.join(video_out_path, name), "w") as f:
        json.dump(pred, f)


def load_model(args, cfg, device: torch.device):
    """The detector on ``device`` in eval mode, with --model_path weights
    laid over the seeded init (``load_weights``), or the init alone."""
    model_name = "efficientdet" if args.is_efficientdet else "faster_rcnn"
    model = get_model(cfg, model_name)
    if args.model_path:
        tree = load_weights(args.model_path, model)
    else:
        print("warning: no --model_path, using random weights",
              file=sys.stderr)
        tree = init_params(cfg, seed=0, model_name=model_name)
    params_from_jax(tree, model)
    return model.to(device).eval()


def build_runner(args, cfg, device: torch.device) -> DetectionRunner:
    """``load_model``'s detector wrapped in the pipelined runner."""
    return DetectionRunner(load_model(args, cfg, device),
                           emb_agg=args.emb_agg_method,
                           ship_full_feat=args.get_box_feat)


@contextlib.contextmanager
def perf_logging(args, device: torch.device):
    """With --log_time_and_gpu, a ``PerformanceLogger`` sampling every
    ``PERF_INTERVAL`` s while the block runs; after it, its summary is
    printed and, with --save_util_log_to, its series written (JAX CLI
    :432-452). Yields the logger, or None without the flag."""
    if not args.log_time_and_gpu:
        yield None
        return
    perf = PerformanceLogger(interval=PERF_INTERVAL, device=device).start()
    try:
        yield perf
    finally:
        perf.end()
    print("perf:", perf.summary())
    if args.save_util_log_to:
        perf.save(args.save_util_log_to)


def main(argv=None):
    args = get_args(argv)
    if args.get_box_feat and args.box_feat_path is None:
        raise ValueError("--get_box_feat needs --box_feat_path")
    device = resolve_device(args.device)
    cfg = build_config(args, device)
    runner = None
    if not args.test_frame_extraction:
        runner = build_runner(args, cfg, device)

    classid2name = cfg.classid2name
    coco_to_actev = None
    if args.is_coco_model or args.use_partial_classes:
        # tracked classes are named in ActEV terms (Person/Vehicle/Bike)
        coco_to_actev = dict(coco_obj_to_actev_obj)

    with perf_logging(args, device):
        start = time.time()
        with open(args.video_lst_file) as f:
            videos = [os.path.join(args.video_dir, line.strip())
                      for line in f if line.strip()]
        total_frames = 0
        for video in videos:
            total_frames += process_video(args, cfg, runner, video,
                                          classid2name, coco_to_actev)

        elapsed = time.time() - start
        print("total run time %.1fs, %d frames, %.2f fps"
              % (elapsed, total_frames, total_frames / max(elapsed, 1e-6)))


if __name__ == "__main__":
    main()
