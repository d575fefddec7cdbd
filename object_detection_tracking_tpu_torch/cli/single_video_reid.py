"""Single-video ReID track re-linking CLI (port of
object_detection_tracking_tpu/cli/single_video_reid.py:22-94).

Takes the MOT txt from obj_detect_tracking and merges broken tracklets via
OSNet (Person) / ResNet (Vehicle) appearance features. The same flags as
the JAX CLI, plus ``--device`` (default cuda; with no GPU it raises unless
``--device cpu`` is given). The extractors run in bfloat16 on the GPU and
in float32 on the CPU. ``--use_lijun_video_loader`` asks for the PyAV
reader, which is not ported yet (ROADMAP A12).

  python -m object_detection_tracking_tpu_torch.cli.single_video_reid \
    --video_dir videos --video_lst_file v.lst --track_dir tracks \
    --out_dir tracks_reid \
    --person_reid_model osnet_x1_0.pth --vehicle_reid_model resnet101.pth
"""

from __future__ import annotations

import argparse
import os
import sys

from ..data import open_video
from ..models.reid import FeatureExtractor
from ..reid.single_video import relink_video_tracks, save_tracks


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video_dir", required=True)
    p.add_argument("--video_lst_file", required=True)
    p.add_argument("--track_dir", required=True,
                   help="dir of <video>/<class>/<video>.txt")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--person_reid_model", default=None)
    p.add_argument("--vehicle_reid_model", default=None)
    p.add_argument("--p_reid_model_name", default="osnet_x1_0")
    p.add_argument("--v_reid_model_name", default="resnet101")
    p.add_argument("--tol_num_frame", type=int, default=30)
    p.add_argument("--feature_box_num", type=int, default=5)
    p.add_argument("--feature_box_gap", type=int, default=20)
    p.add_argument("--reject_dist_thres", type=float, default=200.0)
    p.add_argument("--compare_method", default="min_all",
                   choices=["min_all", "avg"])
    p.add_argument("--use_lijun_video_loader", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:N | cpu (no silent CPU fallback)")
    return p.parse_args(argv)


def extractor(model_name: str, model_path: str, device: str
              ) -> FeatureExtractor:
    """The CLIs' extractor: bfloat16 on the GPU, float32 on the CPU."""
    dtype = "float32" if device == "cpu" else "bfloat16"
    return FeatureExtractor(model_name, model_path, compute_dtype=dtype,
                            device=device)


def frame_iterator(path: str, decoder: str):
    vcap = open_video(path, decoder)
    idx = 0
    while True:
        ok, frame = vcap.read()
        if not ok:
            return
        yield frame, idx
        idx += 1


def main(argv=None):
    args = get_args(argv)
    extractors = {}
    if args.person_reid_model:
        extractors["Person"] = extractor(
            args.p_reid_model_name, args.person_reid_model, args.device)
    if args.vehicle_reid_model:
        extractors["Vehicle"] = extractor(
            args.v_reid_model_name, args.vehicle_reid_model, args.device)
    if not extractors:
        print("need --person_reid_model and/or --vehicle_reid_model",
              file=sys.stderr)
        sys.exit(1)

    decoder = "pyav" if args.use_lijun_video_loader else "auto"
    with open(args.video_lst_file) as f:
        videos = [l.strip() for l in f if l.strip()]
    for video in videos:
        videoname = os.path.splitext(os.path.basename(video))[0]
        for cat, ex in extractors.items():
            track_file = os.path.join(args.track_dir, videoname, cat,
                                      f"{videoname}.txt")
            if not os.path.exists(track_file):
                continue
            new_tracks = relink_video_tracks(
                track_file,
                frame_iterator(os.path.join(args.video_dir, video), decoder),
                ex, tol_num_frame=args.tol_num_frame,
                feature_box_num=args.feature_box_num,
                feature_box_gap=args.feature_box_gap,
                reject_dist_thres=args.reject_dist_thres,
                compare_method=args.compare_method)
            out_file = os.path.join(args.out_dir, videoname, cat,
                                    f"{videoname}.txt")
            save_tracks(new_tracks, out_file)
            print(f"{videoname}/{cat}: {len(new_tracks)} tracks")


if __name__ == "__main__":
    main()
