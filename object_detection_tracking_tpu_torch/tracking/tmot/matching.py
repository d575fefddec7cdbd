"""Association costs for the JDE tracker (reference tmot/matching.py).

Quirks preserved because downstream thresholds were tuned against them:
  * IOU uses the legacy +1 pixel convention (cython_bbox semantics);
  * "embedding distance" is plain euclidean cdist over the L2-normalized
    features (the reference ignores its metric kwarg);
  * fuse_motion blends lambda*emb + (1-lambda)*mahalanobis and hard-gates
    at the chi-square 0.95 threshold.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..assignment import lapjv_extended
from ..kalman import chi2inv95


def linear_assignment(cost_matrix: np.ndarray, thresh: float):
    if cost_matrix.size == 0:
        return (np.empty((0, 2), int), tuple(range(cost_matrix.shape[0])),
                tuple(range(cost_matrix.shape[1])))
    x, y = lapjv_extended(cost_matrix, cost_limit=thresh)
    matches = np.asarray([[ix, mx] for ix, mx in enumerate(x) if mx >= 0],
                         dtype=int).reshape(-1, 2)
    return matches, np.where(x < 0)[0], np.where(y < 0)[0]


def ious_plus1(atlbrs: np.ndarray, btlbrs: np.ndarray) -> np.ndarray:
    """IOU matrix with the +1 area convention (cython_bbox parity)."""
    a = np.asarray(atlbrs, np.float64).reshape(-1, 4)
    b = np.asarray(btlbrs, np.float64).reshape(-1, 4)
    out = np.zeros((len(a), len(b)), np.float64)
    if out.size == 0:
        return out
    iw = np.minimum(a[:, None, 2], b[None, :, 2]) - \
        np.maximum(a[:, None, 0], b[None, :, 0]) + 1
    ih = np.minimum(a[:, None, 3], b[None, :, 3]) - \
        np.maximum(a[:, None, 1], b[None, :, 1]) + 1
    inter = np.maximum(iw, 0) * np.maximum(ih, 0)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    np.divide(inter, union, out=out, where=union > 0)
    return out


def iou_distance(atracks: List, btracks: List) -> np.ndarray:
    if (len(atracks) > 0 and isinstance(atracks[0], np.ndarray)) or \
            (len(btracks) > 0 and isinstance(btracks[0], np.ndarray)):
        atlbrs, btlbrs = atracks, btracks
    else:
        atlbrs = [t.tlbr for t in atracks]
        btlbrs = [t.tlbr for t in btracks]
    if len(atlbrs) == 0 or len(btlbrs) == 0:
        return np.zeros((len(atlbrs), len(btlbrs)), np.float64)
    return 1.0 - ious_plus1(np.asarray(atlbrs), np.asarray(btlbrs))


def embedding_distance(tracks: List, detections: List) -> np.ndarray:
    cost = np.zeros((len(tracks), len(detections)), np.float64)
    if cost.size == 0:
        return cost
    det = np.asarray([d.curr_feat for d in detections], np.float64)
    trk = np.asarray([t.smooth_feat for t in tracks], np.float64)
    d2 = np.maximum(
        np.square(trk).sum(1)[:, None] + np.square(det).sum(1)[None, :]
        - 2.0 * trk @ det.T, 0.0)
    return np.maximum(0.0, np.sqrt(d2))


def fuse_motion(kf, cost_matrix: np.ndarray, tracks: List, detections: List,
                only_position: bool = False,
                lambda_: float = 0.98) -> np.ndarray:
    if cost_matrix.size == 0:
        return cost_matrix
    gating_dim = 2 if only_position else 4
    gating_threshold = chi2inv95[gating_dim]
    measurements = np.asarray([d.to_xyah() for d in detections])
    means = np.stack([t.mean for t in tracks])
    covs = np.stack([t.covariance for t in tracks])
    # one batched Cholesky+solve for all tracks (kalman.py:
    # gating_distance_multi) instead of a per-track Python loop
    gd = kf.gating_distance_multi(means, covs, measurements, only_position)
    cost_matrix[gd > gating_threshold] = np.inf
    return lambda_ * cost_matrix + (1 - lambda_) * gd
