"""Visualize MOT track txt onto frames or an mp4 with per-track colors
(reference vis_tracks.py).

Parity notes (/root/reference/vis_tracks.py):
  * multiple categories per pass (--cat_name Person,Vehicle,
    load_track_file ref :28-47);
  * the 8th MOT column is the multi-camera GLOBAL id (multi_video_reid
    output) — global tracks label "g<id>" and keep one color across all
    videos, local tracks color per (video, id, cat) (ref :178-195);
  * --show_only_global drops local-only tracks (ref :20,186);
  * confidence is appended to the label when != 1 (ref :197-200);
  * a green "# <frame>" counter is stamped top-left (ref :207-209);
  * --to_video writes <despath>/<video>.mp4 at --video_size like the
    reference's 1920x1080 writer (ref :162-213); default writes per-frame
    jpgs (handier for spot checks, and matches this repo's vis_json).

  python -m object_detection_tracking_tpu_torch.cli.vis_tracks \
    videos.lst --video_dir videos --trackpath tracks \
    --cat_name Person,Vehicle --despath vis_tracks [--to_video]
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np

from ..data import open_video
from ..utils.viz import PALETTE_BGR, draw_boxes


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("videonamelst")
    p.add_argument("--video_dir", required=True)
    p.add_argument("--trackpath", required=True,
                   help="<trackpath>/<video>/<cat>/<video>.txt MOT files")
    p.add_argument("--cat_name", default="Person",
                   help="comma-separated category subdirs to overlay")
    p.add_argument("--despath", required=True)
    p.add_argument("--show_only_global", action="store_true",
                   help="only draw rows with a global id (column 8 >= 0)")
    p.add_argument("--to_video", action="store_true",
                   help="write <despath>/<video>.mp4 instead of jpgs")
    p.add_argument("--video_size", default="1920x1080",
                   help="WxH of the --to_video output (frames are resized)")
    p.add_argument("--fps", type=float, default=30.0)
    return p.parse_args(argv)


def load_tracks(track_dir: str, videoname: str, cat_names):
    """frame_id -> [(cat, row[8])] with rows padded to 8 columns
    (frame, id, x, y, w, h, conf, gid)."""
    by_frame = defaultdict(list)
    for cat in cat_names:
        txt = os.path.join(track_dir, videoname, cat, f"{videoname}.txt")
        if not os.path.exists(txt):
            continue
        data = np.loadtxt(txt, delimiter=",", ndmin=2)
        if data.size == 0:
            continue
        if data.shape[1] < 8:
            data = np.pad(data, ((0, 0), (0, 8 - data.shape[1])),
                          constant_values=-1)
        for r in data:
            by_frame[int(r[0])].append((cat, r))
    return by_frame


class ColorAssign:
    """First-seen-order palette assignment keyed by track identity, so a
    global id keeps ONE color across videos (reference
    get_or_create_color_from_dict, vis_tracks.py:50-58)."""

    def __init__(self):
        self._assign = {}

    def __call__(self, key):
        if key not in self._assign:
            self._assign[key] = PALETTE_BGR[len(self._assign)
                                            % len(PALETTE_BGR)]
        return self._assign[key]


def frame_overlays(rows, videoname, colors: ColorAssign,
                   show_only_global: bool):
    """One frame's (boxes, labels, box_colors) from [(cat, row)] rows."""
    boxes, labels, box_colors = [], [], []
    for cat, r in rows:
        gid = int(r[7])
        if gid >= 0:
            key = (gid, cat)
            tid = f"g{gid}"
        else:
            if show_only_global:
                continue
            key = (videoname, int(r[1]), cat)
            tid = f"{int(r[1])}"
        conf = float(r[6])
        conf_str = "" if conf == 1.0 else " %.2f" % conf
        x, y, w, h = r[2:6]
        boxes.append([x, y, x + w, y + h])
        labels.append(f"{cat} #{tid}{conf_str}")
        box_colors.append(colors(key))
    return boxes, labels, box_colors


def main(argv=None):
    import cv2
    args = get_args(argv)
    cats = [c for c in args.cat_name.split(",") if c]
    vw_w, vw_h = (int(v) for v in args.video_size.lower().split("x"))
    with open(args.videonamelst) as f:
        videos = [l.strip() for l in f if l.strip()]
    colors = ColorAssign()  # shared across videos: stable global-id colors
    os.makedirs(args.despath, exist_ok=True)
    for video in videos:
        videoname = os.path.splitext(os.path.basename(video))[0]
        by_frame = load_tracks(args.trackpath, videoname, cats)
        vcap = open_video(os.path.join(args.video_dir, video))
        writer = None
        out_dir = os.path.join(args.despath, videoname)
        if args.to_video:
            writer = cv2.VideoWriter(
                os.path.join(args.despath, f"{videoname}.mp4"),
                cv2.VideoWriter_fourcc(*"mp4v"), args.fps, (vw_w, vw_h))
        else:
            os.makedirs(out_dir, exist_ok=True)
        idx, n = 0, 0
        while True:
            ok, frame = vcap.read()
            if not ok:
                break
            drawn = idx in by_frame
            if drawn:
                boxes, labels, box_colors = frame_overlays(
                    by_frame[idx], videoname, colors,
                    args.show_only_global)
                frame = draw_boxes(frame, boxes, labels, box_colors)
                n += 1
            if writer is not None:
                cv2.putText(frame, "# %d" % idx, (0, 20),
                            cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 255, 0), 2)
                if frame.shape[:2] != (vw_h, vw_w):
                    frame = cv2.resize(frame, (vw_w, vw_h))
                writer.write(frame)
            elif drawn:
                cv2.imwrite(os.path.join(
                    out_dir, "%s_F_%08d.jpg" % (videoname, idx)), frame)
            idx += 1
        if writer is not None:
            writer.release()
        print(f"{videoname}: {'wrote video of ' if args.to_video else 'wrote '}"
              f"{n} track-vis frames")


if __name__ == "__main__":
    main()
