"""Convert MOT-format track txt to per-frame detection json
(reference track_to_json.py / tracks_to_json.py).

Input layout: tracking_dir/<video>/<class>/<video>.txt with rows
``frame,id,x,y,w,h,conf,-1,-1,-1``. Output: per-frame json lists with
track_id, compatible with vis_json.py and the ActEV submission tooling.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from ..class_ids import targetAct2id_bupt, targetClass2id


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trackpath", help="dir of <video>/<class>/<video>.txt")
    p.add_argument("videonamelst")
    p.add_argument("cat_name")
    p.add_argument("despath", help="output json dir")
    p.add_argument("--merged", action="store_true",
                   help="single txt per video (tracks_to_json.py layout)")
    p.add_argument("--bupt_exp", action="store_true",
                   help="use the BUPT activity taxonomy "
                        "(ref track_to_json.py:28-29)")
    return p.parse_args(argv)


def track_txt_to_frames(txt_path: str, cat_name: str, cat_id: int):
    frames = defaultdict(list)
    if not os.path.exists(txt_path):
        return frames
    data = np.loadtxt(txt_path, delimiter=",", ndmin=2)
    if data.size == 0:
        return frames
    for row in data:
        frame_idx, track_id = int(row[0]), int(row[1])
        x, y, w, h = [float(v) for v in row[2:6]]
        conf = float(row[6]) if data.shape[1] > 6 else 1.0
        frames[frame_idx].append({
            "category_id": cat_id,
            "cat_name": cat_name,
            "score": conf,
            "bbox": [round(x, 2), round(y, 2), round(w, 2), round(h, 2)],
            "segmentation": None,
            "trackId": track_id,
        })
    return frames


def main(argv=None):
    args = get_args(argv)
    cat_map = targetAct2id_bupt if args.bupt_exp else targetClass2id
    cat_id = cat_map.get(args.cat_name, 0)
    os.makedirs(args.despath, exist_ok=True)
    with open(args.videonamelst) as f:
        videos = [os.path.splitext(os.path.basename(l.strip()))[0]
                  for l in f if l.strip()]
    for videoname in videos:
        if args.merged:
            txt = os.path.join(args.trackpath, f"{videoname}.txt")
        else:
            txt = os.path.join(args.trackpath, videoname, args.cat_name,
                               f"{videoname}.txt")
        frames = track_txt_to_frames(txt, args.cat_name, cat_id)
        out_dir = os.path.join(args.despath, videoname)
        os.makedirs(out_dir, exist_ok=True)
        for frame_idx, dets in frames.items():
            with open(os.path.join(out_dir, f"{frame_idx}.json"), "w") as f:
                json.dump(dets, f)
        print(f"{videoname}: {len(frames)} frames")


if __name__ == "__main__":
    main()
