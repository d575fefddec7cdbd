"""Single-video track re-linking by appearance (reference
single_video_reid.py:68-388).

A tracker drops ids on occlusion; this pass re-joins tracklet pairs whose
end/start are close in time and space and whose ReID features match:
  1. candidate pairs: track1 ends, track2 starts within tol_num_frame, and
     track2's first box intersects track1's last box expanded by
     (expand_width_p, expand_height_p);
  2. one video decode pass crops feature_box_num boxes per tracklet end/
     start (every feature_box_gap rows);
  3. euclidean feature distance (min over all frame pairs, or mean-pooled),
     merge when below reject_dist_thres, transitively to the earliest id.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np


def load_tracks(track_file: str) -> Dict[int, np.ndarray]:
    """MOT txt -> track_id -> [K, 7] (frame, id, x, y, w, h, conf)."""
    rows = []
    with open(track_file) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 7:
                continue
            rows.append([float(v) for v in parts[:7]])
    if not rows:
        return {}
    data = np.asarray(rows, np.float32)
    data = data[np.lexsort((data[:, 0],))]
    return {int(tid): data[data[:, 1] == tid]
            for tid in np.unique(data[:, 1])}


def _expand_tlwh(tlwh, wp, hp):
    x, y, w, h = tlwh
    return np.array([x - w * wp / 2, y - h * hp / 2,
                     w * (1 + wp), h * (1 + hp)], np.float32)


def _tlwh_intersection(a, b) -> float:
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[0] + a[2], b[0] + b[2])
    y2 = min(a[1] + a[3], b[1] + b[3])
    return max(0.0, x2 - x1) * max(0.0, y2 - y1)


def find_candidate_pairs(track_data: Dict[int, np.ndarray],
                         tol_num_frame: int = 30,
                         expand_width_p: float = 0.1,
                         expand_height_p: float = 0.1) -> Dict[int, List]:
    """track_id -> list of [next_track_id, its_start_frame, my_end_frame]
    (reference preprocess, single_video_reid.py:100-138)."""
    track_ids = sorted(track_data.keys())
    pairs: Dict[int, List] = {}
    for id1 in track_ids:
        end1 = track_data[id1][-1, 0]
        expanded = _expand_tlwh(track_data[id1][-1, 2:6],
                                expand_width_p, expand_height_p)
        for id2 in track_ids:
            if id2 == id1:
                continue
            start2 = track_data[id2][0, 0]
            if start2 <= end1 or start2 - end1 >= tol_num_frame:
                continue
            if _tlwh_intersection(expanded, track_data[id2][0, 2:6]) <= 0:
                continue
            if id1 not in pairs:
                pairs[id1] = [[id2, start2, end1]]
            elif start2 == pairs[id1][0][1]:
                # keep only the earliest-starting competitors
                pairs[id1].append([id2, start2, end1])
    return pairs


def collect_box_requests(track_data: Dict[int, np.ndarray],
                         candidates: Dict[int, List],
                         feature_box_num: int = 5,
                         feature_box_gap: int = 20):
    """Which (frame -> [(tlwh, key, box_idx)]) crops are needed: last boxes
    of each query track, first boxes of each gallery track."""
    needed: Dict[str, List[np.ndarray]] = {}
    for qid in candidates:
        qkey = f"query_{qid}"
        rows = track_data[qid]
        limit = len(rows) if feature_box_num <= 0 else feature_box_num
        needed[qkey] = [rows[-i] for i in
                        range(1, len(rows) + 1, feature_box_gap)][:limit]
        for gid, _, _ in candidates[qid]:
            gkey = f"gallery_{gid}"
            if gkey in needed:
                continue
            rows_g = track_data[gid]
            limit = len(rows_g) if feature_box_num <= 0 else feature_box_num
            needed[gkey] = [rows_g[i] for i in
                            range(0, len(rows_g), feature_box_gap)][:limit]
    frame_data: Dict[int, List] = {}
    for key, boxes in needed.items():
        for box_idx, row in enumerate(boxes):
            frame_data.setdefault(int(row[0]), []).append(
                (row[2:6], key, box_idx))
    return frame_data


def crop_track_boxes(frame_iter, frame_data: Dict[int, List],
                     min_size: int = 2) -> Dict[str, Dict[int, np.ndarray]]:
    """One pass over (frame_bgr, frame_idx) pairs collecting BGR crops."""
    crops: Dict[str, Dict[int, np.ndarray]] = {}
    for image, frame_idx in frame_iter:
        reqs = frame_data.get(int(frame_idx))
        if not reqs:
            continue
        ih, iw = image.shape[:2]
        for tlwh, key, box_idx in reqs:
            x, y, w, h = [int(v) for v in tlwh]
            x = max(0, x)
            y = max(0, y)
            w = min(w, iw - x)
            h = min(h, ih - y)
            crops.setdefault(key, {})
            if w >= min_size and h >= min_size:
                crops[key][box_idx] = image[y:y + h, x:x + w].copy()
    return crops


def _euclidean(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d2 = np.square(a).sum(1)[:, None] + np.square(b).sum(1)[None, :] \
        - 2.0 * a @ b.T
    return np.sqrt(np.maximum(d2, 0.0))


def compute_candidate_distances(candidates: Dict[int, List],
                                crops: Dict[str, Dict[int, np.ndarray]],
                                extractor: Callable,
                                method: str = "min_all"):
    """Append a feature distance to every candidate entry; drop queries with
    no usable crops. candidates entries become
    [gallery_id, start, end, dist] sorted by dist."""
    assert method in ("min_all", "avg")
    drop = []
    for qid in list(candidates):
        qcrops = crops.get(f"query_{qid}", {})
        if not qcrops:
            drop.append(qid)
            continue
        qfeat = extractor([qcrops[i] for i in sorted(qcrops)])
        kept = [c for c in candidates[qid]
                if crops.get(f"gallery_{c[0]}")]
        if not kept:
            drop.append(qid)
            continue
        candidates[qid] = [list(c[:3]) for c in kept]
        for entry in candidates[qid]:
            gcrops = crops[f"gallery_{entry[0]}"]
            gfeat = extractor([gcrops[i] for i in sorted(gcrops)])
            if method == "avg":
                d = float(_euclidean(qfeat.mean(0, keepdims=True),
                                     gfeat.mean(0, keepdims=True))[0, 0])
            else:
                d = float(_euclidean(qfeat, gfeat).min())
            entry.append(d)
        candidates[qid].sort(key=lambda e: e[-1])
    for qid in drop:
        del candidates[qid]
    return candidates


def merge_candidates(candidates: Dict[int, List],
                     track_data: Dict[int, np.ndarray],
                     reject_dist_thres: float = 200.0
                     ) -> Dict[int, np.ndarray]:
    """Merge accepted pairs transitively onto the earliest id (reference
    single_video_reid.py:316-368)."""
    reverse: Dict[int, List] = {}
    for qid in candidates:
        matches = [(e[0], e[-1]) for e in candidates[qid]
                   if e[-1] < reject_dist_thres]
        if matches:
            gid, dist = matches[0]
            reverse.setdefault(gid, []).append(
                (qid, dist, len(track_data[qid])))
    merge_map: Dict[int, int] = {}
    for gid in reverse:
        reverse[gid].sort(key=lambda e: e[2], reverse=True)
        prev = reverse[gid][0][0]
        while prev in merge_map:
            prev = merge_map[prev]
        if gid not in merge_map and gid != prev:
            merge_map[gid] = prev
    new_data: Dict[int, np.ndarray] = {}
    for tid, rows in track_data.items():
        rows = rows.copy()
        out_id = merge_map.get(tid, tid)
        rows[:, 1] = out_id
        if out_id in new_data:
            new_data[out_id] = np.concatenate([new_data[out_id], rows])
        else:
            new_data[out_id] = rows
    return new_data


def relink_video_tracks(track_file: str, frame_iter, extractor: Callable,
                        tol_num_frame: int = 30,
                        feature_box_num: int = 5, feature_box_gap: int = 20,
                        reject_dist_thres: float = 200.0,
                        compare_method: str = "min_all"
                        ) -> Dict[int, np.ndarray]:
    """Full pipeline for one class of one video."""
    track_data = load_tracks(track_file)
    if not track_data:
        return {}
    candidates = find_candidate_pairs(track_data, tol_num_frame)
    if not candidates:
        return track_data
    frame_data = collect_box_requests(track_data, candidates,
                                      feature_box_num, feature_box_gap)
    crops = crop_track_boxes(frame_iter, frame_data)
    compute_candidate_distances(candidates, crops, extractor, compare_method)
    return merge_candidates(candidates, track_data, reject_dist_thres)


def save_tracks(track_data: Dict[int, np.ndarray], out_file: str):
    rows = sorted((r.tolist() for t in track_data for r in track_data[t]),
                  key=lambda x: (x[0], x[1]))
    import os
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    with open(out_file, "w") as fw:
        for r in rows:
            fw.write("%d,%d,%.2f,%.2f,%.2f,%.2f,%.4f,-1,-1,-1\n"
                     % (r[0], r[1], r[2], r[3], r[4], r[5], r[6]))
