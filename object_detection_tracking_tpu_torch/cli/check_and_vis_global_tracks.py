"""Multi-camera mosaic visualization of global track ids
(reference check_and_vis_global_tracks.py).

Reads per-camera MOT txt with the global id in column 8 (multi_video_reid
output), draws each camera's frame with global-id-colored boxes, and tiles
the cameras into one mosaic video/images.
"""

from __future__ import annotations

import argparse
import math
import os
from collections import defaultdict

import numpy as np

from ..data import open_video
from ..utils.viz import color_for_id, draw_boxes


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("videonamelst")
    p.add_argument("--video_dir", required=True)
    p.add_argument("--trackpath", required=True,
                   help="dir of <video>/<class>/<video>.txt with global ids")
    p.add_argument("--cat_name", default="Person")
    p.add_argument("--despath", required=True)
    p.add_argument("--frame_gap", type=int, default=8)
    p.add_argument("--tile_width", type=int, default=640)
    p.add_argument("--max_frames", type=int, default=0)
    return p.parse_args(argv)


def load_global_tracks(txt):
    by_frame = defaultdict(list)
    if os.path.exists(txt):
        data = np.loadtxt(txt, delimiter=",", ndmin=2)
        for r in data:
            by_frame[int(r[0])].append(r)
    return by_frame


def main(argv=None):
    import cv2
    args = get_args(argv)
    with open(args.videonamelst) as f:
        videos = [l.strip() for l in f if l.strip()]
    caps, tracks = [], []
    for video in videos:
        name = os.path.splitext(os.path.basename(video))[0]
        caps.append(open_video(os.path.join(args.video_dir, video)))
        tracks.append(load_global_tracks(os.path.join(
            args.trackpath, name, args.cat_name, f"{name}.txt")))
    os.makedirs(args.despath, exist_ok=True)

    cols = int(math.ceil(math.sqrt(len(caps))))
    rows_n = int(math.ceil(len(caps) / cols))
    idx = 0
    written = 0
    while True:
        frames = []
        ok_any = False
        for cap in caps:
            ok, fr = cap.read()
            ok_any |= ok
            frames.append(fr if ok else None)
        if not ok_any:
            break
        if idx % args.frame_gap == 0:
            tiles = []
            for ci, fr in enumerate(frames):
                if fr is None:
                    fr = np.zeros((360, args.tile_width, 3), np.uint8)
                rows = tracks[ci].get(idx, [])
                boxes, labels, colors = [], [], []
                for r in rows:
                    gid = int(r[7]) if len(r) > 7 else -1
                    x, y, w, h = r[2:6]
                    boxes.append([x, y, x + w, y + h])
                    labels.append(f"G{gid}" if gid > 0 else f"L{int(r[1])}")
                    colors.append(color_for_id(gid if gid > 0 else 0))
                fr = draw_boxes(fr, boxes, labels, colors)
                scale = args.tile_width / fr.shape[1]
                fr = cv2.resize(fr, (args.tile_width,
                                     int(fr.shape[0] * scale)))
                tiles.append(fr)
            th = max(t.shape[0] for t in tiles)
            tiles = [np.pad(t, ((0, th - t.shape[0]), (0, 0), (0, 0)))
                     for t in tiles]
            while len(tiles) < rows_n * cols:
                tiles.append(np.zeros_like(tiles[0]))
            grid = np.concatenate(
                [np.concatenate(tiles[r * cols:(r + 1) * cols], axis=1)
                 for r in range(rows_n)], axis=0)
            cv2.imwrite(os.path.join(args.despath, "mosaic_F_%08d.jpg" % idx),
                        grid)
            written += 1
            if args.max_frames and written >= args.max_frames:
                break
        idx += 1
    print(f"wrote {written} mosaic frames to {args.despath}")


if __name__ == "__main__":
    main()
