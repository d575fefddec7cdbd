"""Multi-camera ReID CLI: assign global track ids across synchronized
cameras (port of object_detection_tracking_tpu/cli/multi_video_reid.py:
35-125). The same flags as the JAX CLI, plus ``--device`` (default cuda;
with no GPU it raises unless ``--device cpu`` is given).

Camera config json:
  {
    "reference_camera": "cam1",
    "videos": {
      "cam1": {"video": "cam1.mp4", "camera_file": "cam1.krtd",
               "frame_offset": 0},
      "cam2": {...}
    }
  }
Track inputs: <track_dir>/<name>/<class>/<name>.txt (obj_detect_tracking
output). Output: same layout with the global id written in MOT column 8.
"""

from __future__ import annotations

import argparse
import json
import os

from ..reid.cameras import compute_c1_to_c2_homography, parse_camera_file
from ..reid.multi_video import (add_foot_points, link_across_cameras,
                                save_global_tracks)
from ..reid.single_video import (collect_box_requests, crop_track_boxes,
                                 load_tracks)
from .single_video_reid import extractor, frame_iterator


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--camera_config", required=True)
    p.add_argument("--video_dir", required=True)
    p.add_argument("--track_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--person_reid_model", required=True)
    p.add_argument("--vehicle_reid_model", required=True)
    p.add_argument("--p_reid_model_name", default="osnet_x1_0")
    p.add_argument("--v_reid_model_name", default="resnet101")
    p.add_argument("--feature_box_num", type=int, default=5)
    p.add_argument("--feature_box_gap", type=int, default=20)
    p.add_argument("--spatial_dist_tol", type=float, default=50.0)
    p.add_argument("--feat_cost_limit", type=float, default=998.0)
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:N | cpu (no silent CPU fallback)")
    return p.parse_args(argv)


def extract_track_features(track_data, video_path, extractor,
                           feature_box_num, feature_box_gap):
    """All tracks are 'queries': crop a few boxes per track in one decode
    pass, return track_id -> [K, D] features."""
    fake_candidates = {tid: [] for tid in track_data}
    frame_data = collect_box_requests(track_data, fake_candidates,
                                      feature_box_num, feature_box_gap)
    crops = crop_track_boxes(frame_iterator(video_path, "auto"), frame_data)
    feats = {}
    for tid in track_data:
        c = crops.get(f"query_{tid}", {})
        if c:
            feats[tid] = extractor([c[i] for i in sorted(c)])
    return feats


def main(argv=None):
    args = get_args(argv)
    with open(args.camera_config) as f:
        cam_cfg = json.load(f)
    videos = cam_cfg["videos"]
    ref_name = cam_cfg.get("reference_camera", sorted(videos)[0])
    ref = parse_camera_file(os.path.join(
        args.video_dir, videos[ref_name]["camera_file"]))

    extractors = {
        "Person": extractor(args.p_reid_model_name,
                            args.person_reid_model, args.device),
        "Vehicle": extractor(args.v_reid_model_name,
                             args.vehicle_reid_model, args.device),
    }

    all_tracks = {}
    frame_offsets = {}
    for name, info in videos.items():
        frame_offsets[name] = float(info.get("frame_offset", 0))
        cam = parse_camera_file(os.path.join(args.video_dir,
                                             info["camera_file"]))
        hom = None
        if name != ref_name:
            hom = compute_c1_to_c2_homography(*cam, *ref)
        video_path = os.path.join(args.video_dir, info["video"])
        all_tracks[name] = {}
        for cat, ex in extractors.items():
            base = os.path.splitext(os.path.basename(info["video"]))[0]
            track_file = os.path.join(args.track_dir, base, cat,
                                      f"{base}.txt")
            if not os.path.exists(track_file):
                continue
            track_data = load_tracks(track_file)
            feats = extract_track_features(
                track_data, video_path, ex,
                args.feature_box_num, args.feature_box_gap)
            all_tracks[name][cat] = {
                tid: (add_foot_points(track_data[tid], hom), feats[tid])
                for tid in track_data if tid in feats}

    gt = link_across_cameras(all_tracks, frame_offsets,
                             spatial_dist_tol=args.spatial_dist_tol,
                             feat_cost_limit=args.feat_cost_limit)

    for name, info in videos.items():
        base = os.path.splitext(os.path.basename(info["video"]))[0]
        for cat in extractors:
            if cat not in all_tracks.get(name, {}):
                continue
            out_file = os.path.join(args.out_dir, base, cat, f"{base}.txt")
            save_global_tracks(cat, all_tracks[name][cat], gt, out_file,
                               name)
            n_global = len(gt.by_cat.get(cat, {}))
            print(f"{name}/{cat}: {len(all_tracks[name][cat])} local, "
                  f"{n_global} global tracks")


if __name__ == "__main__":
    main()
