"""Extract resized JPEG frames from videos (reference get_frames_resize.py).

Writes ``despath/<videoname>/<videoname>_F_%08d.jpg`` with the short-edge /
max-size resize the detectors use, optionally skipping by frame gap.
"""

from __future__ import annotations

import argparse
import os

from ..data import open_video
from ..ops.boxes import get_new_hw


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("videonamelst")
    p.add_argument("video_dir")
    p.add_argument("despath")
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--maxsize", type=int, default=1333)
    p.add_argument("--frame_gap", type=int, default=1)
    p.add_argument("--use_lijun_video_loader", action="store_true")
    p.add_argument("--use_2level", action="store_true",
                   help="despath/<videoname>/ subdirs (reference layout)")
    p.add_argument("--name_format", default="%s_F_%08d.jpg")
    return p.parse_args(argv)


def main(argv=None):
    import cv2
    args = get_args(argv)
    with open(args.videonamelst) as f:
        videos = [l.strip() for l in f if l.strip()]
    for video in videos:
        videoname = os.path.splitext(os.path.basename(video))[0]
        vcap = open_video(
            os.path.join(args.video_dir, video),
            "pyav" if args.use_lijun_video_loader else "auto")
        out_dir = os.path.join(args.despath, videoname) \
            if args.use_2level else args.despath
        os.makedirs(out_dir, exist_ok=True)
        idx, n = 0, 0
        while True:
            ok, frame = vcap.read()
            if not ok:
                break
            if idx % args.frame_gap == 0:
                h, w = frame.shape[:2]
                neww, newh = get_new_hw(h, w, args.size, args.maxsize)
                if (neww, newh) != (w, h):
                    frame = cv2.resize(frame, (neww, newh),
                                       interpolation=cv2.INTER_LINEAR)
                cv2.imwrite(os.path.join(
                    out_dir, args.name_format % (videoname, idx)), frame)
                n += 1
            idx += 1
        print(f"{videoname}: {n} frames")


if __name__ == "__main__":
    main()
