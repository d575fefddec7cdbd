"""Detection evaluation: per-class AP/AR at IOU 0.5.

Reference parity (utils.py:436-846, eval.py): greedy score-ranked matching
per image (match_detection), global score-sorted accumulation
(aggregate_eval), AP normalized by total gt (computeAP_v2) and AR as
TP/num_gt (computeAR_2). Boxes are COCO xywh on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .ops.boxes import pairwise_iou_np


def _xywh_to_xyxy(boxes) -> np.ndarray:
    b = np.asarray(boxes, np.float64).reshape(-1, 4).copy()
    b[:, 2] += b[:, 0]
    b[:, 3] += b[:, 1]
    return b


def iou_xywh(d: Sequence, g: Sequence) -> np.ndarray:
    """[D, G] IOU over xywh boxes (pycocotools.iou iscrowd=0 semantics)."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    return pairwise_iou_np(_xywh_to_xyxy(d), _xywh_to_xyxy(g))


def match_detection(d: Sequence, g: Sequence, ious: np.ndarray,
                    iou_thres: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy match score-ranked detections to gt (utils.py:573-603).
    Returns (dtm [D], gtm [G]) with matched indices or -1."""
    D, G = len(d), len(g)
    gtm = -np.ones(G)
    dtm = -np.ones(D)
    for didx in range(D):
        best_iou = iou_thres
        m = -1
        for gidx in range(G):
            if gtm[gidx] >= 0:
                continue
            if ious[didx, gidx] < best_iou:
                continue
            best_iou = ious[didx, gidx]
            m = gidx
        if m == -1:
            continue
        gtm[m] = didx
        dtm[didx] = m
    return dtm, gtm


def gather_dt(boxes, probs, labels, eval_target: Dict, targetid2class: Dict,
              tococo: bool = False, coco_class_names=None) -> Dict:
    """Detector output (xyxy) -> per-eval-class list of (xywh box, prob)
    (utils.py:436-471)."""
    target_dt_boxes = {one: [] for one in eval_target}
    for box, prob, label in zip(boxes, probs, labels):
        box = list(box)
        box[2] -= box[0]
        box[3] -= box[1]
        if tococo:
            cat_name = coco_class_names[int(label)]
            target_class = None
            for t in eval_target:
                if cat_name in eval_target[t]:
                    target_class = t
        else:
            cat_name = targetid2class[int(label)]
            target_class = cat_name if cat_name in eval_target else None
        if target_class is None:
            continue
        target_dt_boxes[target_class].append(
            ([float(round(x, 2)) for x in box], float(round(prob, 4))))
    return target_dt_boxes


def gather_gt(anno_boxes, anno_labels, eval_target: Dict,
              targetid2class: Dict) -> Dict:
    gt_boxes = {one: [] for one in eval_target}
    for box, label in zip(anno_boxes, anno_labels):
        name = targetid2class[int(label)]
        if name in eval_target:
            b = [float(round(x, 1)) for x in box]
            b[2] -= b[0]
            b[3] -= b[1]
            gt_boxes[name].append(b)
    return gt_boxes


def match_dt_gt(e: Dict, imgid, target_dt_boxes: Dict, gt_boxes: Dict,
                eval_target: Dict):
    """Accumulate one image's matches into e[class][imgid]
    (utils.py:529-548)."""
    for target_class in eval_target:
        dts = sorted(target_dt_boxes[target_class], key=lambda x: -x[1])
        d = [box for box, prob in dts]
        dscores = [prob for box, prob in dts]
        g = gt_boxes[target_class]
        dm, _ = match_detection(d, g, iou_xywh(d, g), iou_thres=0.5)
        e[target_class][imgid] = {
            "dscores": dscores, "dm": dm, "gt_num": len(g)}


def computeAP_v2(dm: np.ndarray, total_gt: int) -> float:
    rels = 0
    score = 0.0
    for rank, one in enumerate(dm, 1):
        if one >= 0:
            rels += 1
            score += rels / float(rank)
    return score / float(total_gt) if total_gt else score


def computeAR_2(dm: np.ndarray, num_gt: int) -> float:
    if num_gt == 0:
        return 1.0
    return sum(1 for one in dm if one >= 0) / float(num_gt)


def aggregate_eval(e: Dict, maxDet: int = 100
                   ) -> Tuple[Dict[str, float], Dict[str, float]]:
    aps, ars = {}, {}
    for catId in e:
        e_c = e[catId]
        dscores = np.concatenate(
            [np.asarray(e_c[i]["dscores"][:maxDet]) for i in e_c]
            or [np.zeros(0)])
        inds = np.argsort(-dscores, kind="mergesort")
        dm = np.concatenate(
            [np.asarray(e_c[i]["dm"][:maxDet]) for i in e_c]
            or [np.zeros(0)])[inds]
        num_gt = int(np.sum([e_c[i]["gt_num"] for i in e_c]))
        aps[catId] = computeAP_v2(dm, num_gt)
        ars[catId] = computeAR_2(dm, num_gt)
    return aps, ars


def weighted_average(aps: Dict, ars: Dict,
                     eval_target_weight: Optional[Dict] = None):
    if eval_target_weight is not None:
        return (sum(aps[c] * eval_target_weight[c] for c in aps),
                sum(ars[c] * eval_target_weight[c] for c in ars))
    return (sum(aps.values()) / float(len(aps)),
            sum(ars.values()) / float(len(ars)))


def compute_ap_101(dm: np.ndarray, total_gt: int) -> float:
    """COCO-style AP: 101-point interpolated precision over recall
    (COCOeval's accumulate), for one IOU threshold's global score-sorted
    match vector."""
    if total_gt == 0:
        return 0.0
    tp = np.asarray(dm) >= 0
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(~tp)
    recall = tp_cum / total_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    # precision envelope (monotone non-increasing from the right)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    out = 0.0
    for r in np.linspace(0, 1, 101):
        idx = np.searchsorted(recall, r, side="left")
        out += precision[idx] if idx < len(precision) else 0.0
    return out / 101.0


def evaluate_coco_style(images, eval_target: Dict,
                        iou_thresholds=None, maxDet: int = 100):
    """COCO-protocol mAP over IOU in [.5:.05:.95] (the all-area,
    maxDets=100 slice of COCOeval — pycocotools is not available in this
    image, so this is a native implementation).

    images: iterable of (dt_by_class, gt_by_class) dicts as produced by
    gather_dt / gather_gt. Returns (ap_per_class dict, mAP, mAP50)."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 0.999, 0.05)
    per_t = {t: {c: {} for c in eval_target} for t in iou_thresholds}
    for imgid, (dt, gt) in enumerate(images):
        for c in eval_target:
            dts = sorted(dt.get(c, []), key=lambda x: -x[1])[:maxDet]
            d = [b for b, p in dts]
            scores = [p for b, p in dts]
            g = gt.get(c, [])
            ious = iou_xywh(d, g)
            for t in iou_thresholds:
                dm, _ = match_detection(d, g, ious, iou_thres=t)
                per_t[t][c][imgid] = {
                    "dscores": scores, "dm": dm, "gt_num": len(g)}
    ap_per_class = {}
    ap50_per_class = {}
    for c in eval_target:
        aps = []
        for t in iou_thresholds:
            e_c = per_t[t][c]
            if not e_c:
                continue
            dscores = np.concatenate(
                [np.asarray(e_c[i]["dscores"]) for i in e_c] or [np.zeros(0)])
            order = np.argsort(-dscores, kind="mergesort")
            dm = np.concatenate(
                [np.asarray(e_c[i]["dm"]) for i in e_c]
                or [np.zeros(0)])[order]
            num_gt = int(np.sum([e_c[i]["gt_num"] for i in e_c]))
            ap = compute_ap_101(dm, num_gt)
            aps.append(ap)
            if abs(t - 0.5) < 1e-9:
                ap50_per_class[c] = ap
        ap_per_class[c] = float(np.mean(aps)) if aps else 0.0
    classes = [c for c in ap_per_class]
    mAP = float(np.mean([ap_per_class[c] for c in classes])) if classes else 0.0
    mAP50 = float(np.mean([ap50_per_class.get(c, 0.0) for c in classes])) \
        if classes else 0.0
    return ap_per_class, mAP, mAP50
