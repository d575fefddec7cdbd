"""Multi-camera global track linking (reference multi_video_reid.py).

Tracks from synchronized cameras are compared pairwise:
  1. spatial gate: each track's foot points (bottom-center of the box) are
     warped through the ground-plane homography into a common reference
     camera; tracks whose time-intersected warped trajectories stay within
     ``tol`` mean pixels are candidates (compute_spatial_dist);
  2. appearance: min squared-euclidean distance over all feature pairs for
     spatially-gated candidates (compute_feature_dist);
  3. optimal bipartite assignment per camera pair (lapjv with cost limit),
     merged transitively into global ids (link_across_cameras);
  4. MOT output carries the global id in column 8.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..tracking.assignment import lapjv_extended
from .cameras import warp_points

BIG = 9999.0


def add_foot_points(rows: np.ndarray, homography=None) -> np.ndarray:
    """rows [K, >=7] MOT -> [K, cols+2] with (warped) foot point appended.
    Foot point = (x + w/2, y + h)."""
    fx = rows[:, 2] + rows[:, 4] / 2.0
    fy = rows[:, 3] + rows[:, 5]
    pts = np.stack([fx, fy], axis=0)
    if homography is not None:
        pts = warp_points(pts, homography)
    return np.concatenate([rows, pts.T.astype(rows.dtype)], axis=1)


def compute_spatial_dist(tracks1: Dict, tracks2: Dict,
                         frame_offset: float = 0, tol: float = 50,
                         ignore_pairs=((), ())) -> np.ndarray:
    """tracks*: track_id -> (rows [K, >=9 incl. foot pts], feats).
    Mean warped-foot-point distance over time-intersected frames; BIG when
    no intersection or above tol (multi_video_reid.py:262-305)."""
    ids1, ids2 = sorted(tracks1), sorted(tracks2)
    frame_offset = int(frame_offset)
    out = np.full((len(ids1), len(ids2)), BIG)
    for i, id1 in enumerate(ids1):
        rows1 = tracks1[id1][0]
        f2p1 = {int(r[0]): r[-2:] for r in rows1}
        for j, id2 in enumerate(ids2):
            rows2 = tracks2[id2][0]
            f2p2 = {int(r[0]) + frame_offset: r[-2:] for r in rows2}
            common = sorted(set(f2p1) & set(f2p2))
            if not common:
                continue
            p1 = np.array([f2p1[f] for f in common])
            p2 = np.array([f2p2[f] for f in common])
            mean_dist = float(np.linalg.norm(p1 - p2, axis=1).mean())
            if mean_dist <= tol:
                out[i, j] = mean_dist
    for i, id1 in enumerate(ids1):
        for j, id2 in enumerate(ids2):
            if id1 in ignore_pairs[0] and id2 in ignore_pairs[1]:
                out[i, j] = BIG
    return out


def compute_feature_dist(tracks1: Dict, tracks2: Dict,
                         spatial_dist: np.ndarray) -> np.ndarray:
    """Min squared L2 over all feature pairs, only where spatially gated
    (multi_video_reid.py:308-324)."""
    ids1, ids2 = sorted(tracks1), sorted(tracks2)
    out = np.full((len(ids1), len(ids2)), 999.0)
    for i, id1 in enumerate(ids1):
        f1 = np.asarray(tracks1[id1][1])
        for j, id2 in enumerate(ids2):
            if spatial_dist[i, j] >= BIG:
                continue
            f2 = np.asarray(tracks2[id2][1])
            d2 = np.square(f1).sum(1)[:, None] + \
                np.square(f2).sum(1)[None, :] - 2.0 * f1 @ f2.T
            out[i, j] = float(np.maximum(d2, 0).min())
    return out


class GlobalTracks:
    """global id -> set of (video_name, track_id), per class."""

    def __init__(self):
        self.by_cat: Dict[str, Dict[int, set]] = {}

    def create_or_merge(self, cat_name: str, video1: str, id1: int,
                        video2: str, id2: int):
        cat = self.by_cat.setdefault(cat_name, {})
        k1, k2 = (video1, id1), (video2, id2)
        found = None
        for gid, members in cat.items():
            if k1 in members or k2 in members:
                found = gid
                break
        if found is None:
            cat[len(cat) + 1] = {k1, k2}
        else:
            cat[found].update((k1, k2))

    def local_to_global(self, cat_name: str, video_name: str
                        ) -> Dict[int, int]:
        out = {}
        for gid, members in self.by_cat.get(cat_name, {}).items():
            for vn, tid in members:
                if vn == video_name:
                    out[tid] = gid
        return out

    def linked_pairs(self, cat_name: str, video1: str, video2: str):
        """Track ids of each video already in some common global track —
        used as the next round's ignore list."""
        in1, in2 = [], []
        for members in self.by_cat.get(cat_name, {}).values():
            v1 = [tid for vn, tid in members if vn == video1]
            v2 = [tid for vn, tid in members if vn == video2]
            if v1 and v2:
                in1 += v1
                in2 += v2
        return in1, in2


def link_across_cameras(all_tracks: Dict[str, Dict[str, Dict]],
                        frame_offsets: Dict[str, float],
                        spatial_dist_tol: float = 50.0,
                        feat_cost_limit: float = 998.0) -> GlobalTracks:
    """all_tracks: video_name -> cat_name -> {track_id: (rows, feats)}.
    Pairwise over videos, per class; optimal assignment on the feature cost
    (multi_video_reid.py:500-534)."""
    gt = GlobalTracks()
    videos = sorted(all_tracks)
    for i in range(len(videos)):
        for j in range(i + 1, len(videos)):
            v1, v2 = videos[i], videos[j]
            for cat in sorted(set(all_tracks[v1]) | set(all_tracks[v2])):
                tracks1 = all_tracks[v1].get(cat, {})
                tracks2 = all_tracks[v2].get(cat, {})
                if not tracks1 or not tracks2:
                    continue
                offset = frame_offsets.get(v2, 0) - frame_offsets.get(v1, 0)
                ignore = gt.linked_pairs(cat, v1, v2)
                sd = compute_spatial_dist(tracks1, tracks2, offset,
                                          tol=spatial_dist_tol,
                                          ignore_pairs=ignore)
                fd = compute_feature_dist(tracks1, tracks2, sd)
                x, _ = lapjv_extended(fd, cost_limit=feat_cost_limit)
                ids1, ids2 = sorted(tracks1), sorted(tracks2)
                for ix, match in enumerate(x):
                    if match >= 0:
                        gt.create_or_merge(cat, v1, ids1[ix],
                                           v2, ids2[match])
    return gt


def save_global_tracks(cat_name: str, track_data: Dict, gt: GlobalTracks,
                       out_file: str, video_name: str):
    """MOT rows with the global id in column 8 (multi_video_reid.py:383-408).
    track_data: track_id -> (rows, feats)."""
    import os
    l2g = gt.local_to_global(cat_name, video_name)
    rows = sorted((r for tid in track_data for r in track_data[tid][0]),
                  key=lambda r: (r[0], r[1]))
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    with open(out_file, "w") as fw:
        for r in rows:
            gid = l2g.get(int(r[1]), -1)
            fw.write("%d,%d,%.2f,%.2f,%.2f,%.2f,%.4f,%d,-1,-1\n"
                     % (r[0], r[1], r[2], r[3], r[4], r[5], r[6], gid))
