"""Whether the detector's outputs are correct: the readings that compare a
sample of the window's outputs with the plain float32 reference, and the
limits they are held to.

For each sampled frame the reference recomputes the frame from its pixels
and the seeded tree, then reads the program's outputs for that frame:

``det_gap``
    For each valid detection (box, label, score) of the program, the
    reference's candidates of that class (its box head over every level's
    top 1.5 K anchors before NMS, a superset of the proposals either side
    can keep) are searched for the closest one by max(1 - IOU, |score -
    candidate score| / candidate score); the detection's gap is that
    distance. Where the program has fewer valid detections than the
    reference's own forward, each missing one counts 1. The reading is
    the median gap over the sample: some detections come from proposals
    that a bfloat16 RPN ranks across a top-k cut (or a tie) and the
    float32 one does not, and their share swings with the seed (the 90th
    percentile read 0.16 on one sound seed), so the median is the steady
    reading. It covers the backbone, FPN, RPN with N1, ROIAlign (B1) at
    P=7, the box head and the per-class selection.
``recall_gap``
    The other way round: for each of the reference's own final
    detections, the program's detections of that class are searched for
    the closest by the same distance (1 where the program has none of the
    class); the reading is the median over the sample. ``det_gap`` finds
    each program detection among genuine candidates, so a program that
    keeps the wrong ones (an N1 that suppresses too much, a wrong top-R
    pick) reads ~0 there; here each reference detection it lost reads
    about 1 - IOU to its nearest same-class neighbour, or 1.
``recall_miss``
    The share of the reference's detections with no program detection of
    the same class at IOU 0.5 or more. Where scores tie across the
    ``result_per_im`` cut, as with ActEV's 16 near-uniform classes, a
    bfloat16 program keeps a neighbour of a reference detection about as
    often as the detection itself, and the median ``recall_gap`` swings
    with the seed; this share does not.
``feat_err``
    The reference's 7x7 features of the program's own final boxes,
    mean-pooled, against the program's pooled features: the largest
    relative L2 error over the sampled detections.
``mask_err``
    The reference's mask head over the program's final boxes and labels
    (B1 at P=14, the mask head): the largest absolute gap of a mask
    probability.
``nms_excess``
    The configuration's own guarantee that greedy NMS at ``nms_thres``
    leaves no two detections of one class overlapping by more than it:
    the largest same-class IOU among the program's detections of a frame
    beyond ``nms_thres`` (0 when none exceeds it). Exact: its limit is 0.
``count_gap``
    The largest difference, over the frames, between the program's
    number of valid detections and the reference's. Exact: its limit is 0
    (both keep ``result_per_im`` of thousands of candidates above
    ``score_thres``), so a frame left without its outputs fails.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..reference import detector as ref

def _t(x, dev):
    return torch.as_tensor(np.asarray(x)).to(dev)


@torch.no_grad()
def readings(reference: ref.ReferenceDetector, frames: Sequence[np.ndarray],
             outputs: Sequence[Dict[str, np.ndarray]]) -> Dict[str, float]:
    """The readings (module note) of ``outputs`` (one dict a frame, the
    program's host outputs for it) against ``reference`` on ``frames``
    ([h, w, 3] BGR uint8)."""
    m = reference.m
    dev = reference.dev
    kk = m["rpn_post_nms_topk"]
    gaps, rgaps, misses = [], [], []
    feats, masks, excess, counts = [], [], [], []
    with ref.no_tf32():
        for frame, out in zip(frames, outputs):
            x = _t(frame, dev)[None]
            feat = reference.features(x)
            boxes, valid = reference.proposals(feat)
            dec, probs = reference.box_head(feat, boxes, valid)
            rb, rl, rp, rv, _ = reference.predictions(dec, probs, valid)
            n_ref = int(rv.sum())
            sup, sv = reference.proposals(feat, topk=math.ceil(1.5 * kk),
                                          run_nms=False)
            sdec, sprobs = reference.box_head(feat, sup, sv)
            pv = _t(out["final_valid"], dev).bool()
            pb = _t(out["final_boxes"], dev).float()
            pl = _t(out["final_labels"], dev).long()
            pp = _t(out["final_probs"], dev).float()
            d = torch.nonzero(pv).flatten()
            cls = (pl[d] - 1).clamp(0, sdec.shape[2] - 1)
            cand = sdec[0][:, cls].transpose(0, 1)            # [D, Ks, 4]
            cprob = sprobs[0][:, cls + 1].transpose(0, 1)     # [D, Ks]
            iou = ref.pairwise_iou(pb[d][:, None, :], cand)[:, 0]
            rel = (pp[d][:, None] - cprob).abs() / cprob.clamp_min(1e-12)
            dist = torch.maximum(1.0 - iou, rel)
            dist = torch.where(sv[0][None, :], dist, float("inf"))
            g = dist.min(-1).values if len(d) else torch.zeros(0, device=dev)
            missing = max(0, n_ref - len(d))
            gaps.append(g.cpu().numpy().tolist() + [1.0] * missing)
            counts.append(abs(n_ref - len(d)))
            # the reference's detections among the program's
            r = torch.nonzero(rv[0]).flatten()
            same = rl[0][r][:, None] == pl[d][None, :]            # [R, D]
            riou = torch.where(same, ref.pairwise_iou(rb[0][r], pb[d]), 0.0)
            rref = rp[0][r][:, None]
            rrel = (pp[d][None, :] - rref).abs() / rref.clamp_min(1e-12)
            rdist = torch.where(same, torch.maximum(1.0 - riou, rrel), 1.0)
            rg = (rdist.min(-1).values if len(d) else
                  torch.ones(len(r), device=dev))
            rgaps.append(rg.clamp(max=1.0).cpu().numpy().tolist())
            hit = (riou >= 0.5).any(-1) if len(d) else torch.zeros(
                len(r), dtype=torch.bool, device=dev)
            misses.append((~hit).cpu().numpy().tolist())
            # pooled features at the program's boxes
            rf = reference.pooled(feat, pb[None].contiguous(), pv[None])[0]
            pf = _t(out["pooled_box_feat"], dev).float()
            num = (pf[d] - rf[d]).norm(dim=-1)
            den = rf[d].norm(dim=-1).clamp_min(1e-12)
            feats.append((num / den).cpu().numpy().tolist())
            if m["mask"]:
                rm = reference.masks(feat, pb[None].contiguous(), pv[None],
                                     (pl - 1)[None])[0]
                gm = (_t(out["final_masks"], dev).float() - rm).abs()[d]
                masks.append(float(gm.max()) if len(d) else 0.0)
            same = (pl[d][:, None] == pl[d][None, :]) & ~torch.eye(
                len(d), dtype=torch.bool, device=dev)
            over = torch.where(same, ref.pairwise_iou(pb[d], pb[d]), 0.0)
            top = float(over.max()) if len(d) > 1 else 0.0
            excess.append(max(0.0, top - m["nms_thres"]))

    def flat(rows):
        return np.asarray([v for r in rows for v in r] or [0.0])

    def pct(x, q):
        return float(np.percentile(x, q, method="inverted_cdf"))
    every, fe, rec = flat(gaps), flat(feats), flat(rgaps)
    out = {"det_gap": pct(every, 50), "recall_gap": pct(rec, 50),
           "recall_miss": float(flat(misses).mean()),
           "feat_err": float(fe.max()),
           "nms_excess": max(excess), "count_gap": float(max(counts)),
           # beside them, not compared
           "det_gap_p90": pct(every, 90), "det_gap_max": float(every.max()),
           "recall_gap_p90": pct(rec, 90)}
    if m["mask"]:
        out["mask_err"] = max(masks)
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every limited reading at or
    under its limit; a reading that is missing or not finite fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, float("nan"))
        table[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, table


def control_outputs(reference: ref.ReferenceDetector,
                    frames: Sequence[np.ndarray]) -> List[dict]:
    """The reference's own outputs for ``frames``, as host numpy dicts:
    with ``reference.quant`` set, the lower-precision control put in the
    program's place."""
    outs = []
    with torch.no_grad(), ref.no_tf32():
        for frame in frames:
            o = reference.detect(_t(frame, reference.dev)[None])
            outs.append({k: v[0].float().cpu().numpy() if v.is_floating_point()
                         else v[0].cpu().numpy() for k, v in o.items()})
    return outs
