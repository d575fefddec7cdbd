"""Native multi-object-tracking metrics: CLEAR-MOT (MOTA/MOTP/IDSW) and
IDF1.

The reference emits MOT-format track files and defers scoring to external
tools (its README points at the ActEV/MOT challenges); this module scores
them natively so the tracking stack has a first-party quality gate
(`cli.track_quality_proof`) in the zero-egress environment.

Definitions follow the standard formulations:
- CLEAR-MOT (Bernardin & Stiefelhagen 2008): per-frame matching keeps the
  previous gt->hyp assignment when it still overlaps (IOU >= threshold),
  assigns the rest by Hungarian on IOU, and counts an ID switch when a
  gt's new hypothesis differs from its LAST known hypothesis.
  MOTA = 1 - (FN + FP + IDSW) / total_gt; MOTP = mean IOU of matches.
- IDF1 (Ristani et al. 2016): a global bipartite assignment between gt
  and hypothesis identities maximizing co-occurring (IOU-overlapping)
  frames; IDF1 = 2*IDTP / (2*IDTP + IDFP + IDFN).

Inputs are {frame_idx: [(track_id, (x1, y1, x2, y2)), ...]} dicts (any
hashable track ids). Boxes are axis-aligned pixel coordinates.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Box = Tuple[float, float, float, float]
FrameTracks = Dict[int, List[Tuple[object, Box]]]


def _iou_matrix(a: Sequence[Box], b: Sequence[Box]) -> np.ndarray:
    if not a or not b:
        return np.zeros((len(a), len(b)), np.float32)
    A = np.asarray(a, np.float32)[:, None, :]
    B = np.asarray(b, np.float32)[None, :, :]
    x1 = np.maximum(A[..., 0], B[..., 0])
    y1 = np.maximum(A[..., 1], B[..., 1])
    x2 = np.minimum(A[..., 2], B[..., 2])
    y2 = np.minimum(A[..., 3], B[..., 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (A[..., 2] - A[..., 0]) * (A[..., 3] - A[..., 1])
    area_b = (B[..., 2] - B[..., 0]) * (B[..., 3] - B[..., 1])
    union = area_a + area_b - inter
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def _hungarian_max(iou: np.ndarray, thr: float):
    """Maximize total IOU; return [(i, j)] pairs with IOU >= thr."""
    from scipy.optimize import linear_sum_assignment
    if iou.size == 0:
        return []
    ri, ci = linear_sum_assignment(-iou)
    return [(i, j) for i, j in zip(ri, ci) if iou[i, j] >= thr]


def clear_mot(gt: FrameTracks, hyp: FrameTracks,
              iou_thr: float = 0.5) -> Dict[str, float]:
    """CLEAR-MOT over all frames present in either input."""
    frames = sorted(set(gt) | set(hyp))
    last_hyp_for_gt: Dict[object, object] = {}
    prev_pairs: Dict[object, object] = {}
    fn = fp = idsw = n_gt = matches = 0
    iou_sum = 0.0
    for t in frames:
        g = gt.get(t, [])
        h = hyp.get(t, [])
        n_gt += len(g)
        g_ids = [x[0] for x in g]
        h_ids = [x[0] for x in h]
        iou = _iou_matrix([x[1] for x in g], [x[1] for x in h])
        pairs: Dict[object, object] = {}
        # 1. keep surviving previous-frame pairs
        used_g, used_h = set(), set()
        for gid, hid in prev_pairs.items():
            if gid in g_ids and hid in h_ids:
                i, j = g_ids.index(gid), h_ids.index(hid)
                if iou[i, j] >= iou_thr:
                    pairs[gid] = hid
                    used_g.add(i)
                    used_h.add(j)
                    iou_sum += float(iou[i, j])
        # 2. Hungarian on the rest
        free_g = [i for i in range(len(g)) if i not in used_g]
        free_h = [j for j in range(len(h)) if j not in used_h]
        sub = iou[np.ix_(free_g, free_h)] if free_g and free_h else \
            np.zeros((len(free_g), len(free_h)), np.float32)
        for i_s, j_s in _hungarian_max(sub, iou_thr):
            i, j = free_g[i_s], free_h[j_s]
            pairs[g_ids[i]] = h_ids[j]
            iou_sum += float(iou[i, j])
        # 3. counts
        matches += len(pairs)
        fn += len(g) - len(pairs)
        fp += len(h) - len(pairs)
        for gid, hid in pairs.items():
            if gid in last_hyp_for_gt and last_hyp_for_gt[gid] != hid:
                idsw += 1
            last_hyp_for_gt[gid] = hid
        prev_pairs = pairs
    mota = 1.0 - (fn + fp + idsw) / max(n_gt, 1)
    motp = iou_sum / max(matches, 1)
    return {"mota": mota, "motp": motp, "idsw": idsw, "fn": fn, "fp": fp,
            "n_gt": n_gt, "n_matches": matches}


def idf1(gt: FrameTracks, hyp: FrameTracks,
         iou_thr: float = 0.5) -> Dict[str, float]:
    """IDF1: global identity assignment maximizing overlapping frames."""
    frames = sorted(set(gt) | set(hyp))
    g_ids = sorted({x[0] for t in gt.values() for x in t}, key=str)
    h_ids = sorted({x[0] for t in hyp.values() for x in t}, key=str)
    g_index = {g: i for i, g in enumerate(g_ids)}
    h_index = {h: j for j, h in enumerate(h_ids)}
    overlap = np.zeros((len(g_ids), len(h_ids)), np.int64)
    total_g = total_h = 0
    for t in frames:
        g = gt.get(t, [])
        h = hyp.get(t, [])
        total_g += len(g)
        total_h += len(h)
        iou = _iou_matrix([x[1] for x in g], [x[1] for x in h])
        for i, (gid, _) in enumerate(g):
            for j, (hid, _) in enumerate(h):
                if iou[i, j] >= iou_thr:
                    overlap[g_index[gid], h_index[hid]] += 1
    idtp = 0
    if overlap.size:
        from scipy.optimize import linear_sum_assignment
        ri, ci = linear_sum_assignment(-overlap)
        idtp = int(overlap[ri, ci].sum())
    idfn = total_g - idtp
    idfp = total_h - idtp
    f1 = 2.0 * idtp / max(2 * idtp + idfp + idfn, 1)
    return {"idf1": f1, "idtp": idtp, "idfp": idfp, "idfn": idfn}


def evaluate_tracks(gt: FrameTracks, hyp: FrameTracks,
                    iou_thr: float = 0.5) -> Dict[str, float]:
    out = clear_mot(gt, hyp, iou_thr)
    out.update(idf1(gt, hyp, iou_thr))
    return out


def load_mot_txt(path: str) -> FrameTracks:
    """Parse MOT rows `frame,id,x,y,w,h,...` (the tracking CLIs' output
    format, ref obj_detect_tracking.py:795-809) into FrameTracks."""
    out: FrameTracks = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 6:
                continue
            t, tid = int(float(parts[0])), int(float(parts[1]))
            x, y, w, h = map(float, parts[2:6])
            out.setdefault(t, []).append((tid, (x, y, x + w, y + h)))
    return out
