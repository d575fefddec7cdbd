"""Visualize per-frame detection json onto frames (reference vis_json.py).

  python -m object_detection_tracking_tpu_torch.cli.vis_json \
    videos.lst --video_dir videos --jsonpath out_json --despath vis \
    --score_thres 0.5
"""

from __future__ import annotations

import argparse
import json
import os


from ..data import open_video
from ..utils.viz import color_for_id, draw_boxes, draw_mask, vis_keypoints


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("videonamelst")
    p.add_argument("--video_dir", required=True)
    p.add_argument("--jsonpath", required=True)
    p.add_argument("--despath", required=True)
    p.add_argument("--score_thres", type=float, default=0.4)
    p.add_argument("--frame_gap", type=int, default=8)
    p.add_argument("--show_mask", action="store_true",
                   help="alpha-blend each detection's RLE 'segmentation' "
                        "(reference vis_json.py mask overlay)")
    p.add_argument("--show_keypoints", action="store_true",
                   help="draw COCO-17 skeletons from each detection's "
                        "'keypoints' field (x,y,score triplets)")
    return p.parse_args(argv)


def draw_dets(frame, dets, show_mask=False, show_keypoints=False):
    """Overlay one frame's detections: masks first (under the box lines),
    then keypoint skeletons, then labeled boxes (reference
    vis_json.py:138-323 ordering). Mask color is stable per category."""
    if show_mask:
        from ..utils.masks import rle_decode
        for d in dets:
            rle = d.get("segmentation")
            if rle:
                frame = draw_mask(frame, rle_decode(rle),
                                  color=color_for_id(d["category_id"]))
    if show_keypoints:
        import numpy as np
        for d in dets:
            kps = d.get("keypoints")
            if kps:
                frame = vis_keypoints(
                    frame, np.asarray(kps, float).reshape(-1, 3).T)
    boxes = [[d["bbox"][0], d["bbox"][1],
              d["bbox"][0] + d["bbox"][2],
              d["bbox"][1] + d["bbox"][3]] for d in dets]
    labels = ["%s_%.2f" % (d["cat_name"], d["score"]) for d in dets]
    return draw_boxes(frame, boxes, labels)


def main(argv=None):
    import cv2
    args = get_args(argv)
    with open(args.videonamelst) as f:
        videos = [l.strip() for l in f if l.strip()]
    for video in videos:
        videoname = os.path.splitext(os.path.basename(video))[0]
        vcap = open_video(os.path.join(args.video_dir, video))
        out_dir = os.path.join(args.despath, videoname)
        os.makedirs(out_dir, exist_ok=True)
        idx = 0
        n = 0
        while True:
            ok, frame = vcap.read()
            if not ok:
                break
            jf = os.path.join(args.jsonpath, videoname, f"{idx}.json")
            if os.path.exists(jf):
                with open(jf) as f:
                    dets = json.load(f)
                dets = [d for d in dets if d["score"] >= args.score_thres]
                frame = draw_dets(frame, dets, args.show_mask,
                                  args.show_keypoints)
                cv2.imwrite(os.path.join(
                    out_dir, "%s_F_%08d.jpg" % (videoname, idx)), frame)
                n += 1
            idx += 1
        print(f"{videoname}: wrote {n} vis frames")


if __name__ == "__main__":
    main()
