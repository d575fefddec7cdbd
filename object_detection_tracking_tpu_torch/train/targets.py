"""Training-target assignment on the device, static shapes, batched over
images (port of object_detection_tracking_tpu/train/targets.py:34-187).

Rules preserved (reference models.py:3380-3486, nn.py:1119-1176):
  * anchors outside the (unpadded) image are ignored;
  * positive: IOU >= pos_thres, plus every anchor that attains a gt's max
    IOU; negative: max IOU < neg_thres; rest ignored (-1);
  * random subsample to rpn_batch_per_im with the fg_ratio cap;
  * proposal sampling: gt boxes appended as proposals, fg iff max IOU >=
    fg_thres, random fg/bg subsample to fastrcnn_batch_per_im, with fixed
    fg/bg slot caps (padded slots carry valid=False).

Randomness is explicit. The random subsamples rank uniform draws; each
function takes them as tensors (``u_fg``, ``u_bg``), or draws them from a
``torch.Generator`` when none are given. JAX draws them from its key tree,
which torch cannot reproduce, so the tests rebuild JAX's draws and pass
them in. Ties sort as JAX's do: the stable ``argsort`` and ``lax.top_k``
put the lower index first, and so do the stable sorts here.

``effdet_anchor_targets`` is EfficientDet's AnchorLabeler: no sampling, so
no draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.boxes import pairwise_iou
from ..ops.nms import sort_desc_stable

NEG = -1e30


class RowDraws:
    """A data-parallel rank's share of a generator's draws: where a batch
    of ``batch`` images would draw [batch, ...] from ``generator``, this
    draws the same and keeps ``rows``, the rank's images of that batch
    (parallel/mesh.py). Every rank of a step then draws what one process
    would for the whole batch."""

    def __init__(self, generator: torch.Generator, batch: int, rows: slice):
        self.generator = generator
        self.batch = batch
        self.rows = rows


def _uniform(u: Optional[torch.Tensor], shape, generator, device
             ) -> torch.Tensor:
    """The given draws, or U[0, 1) draws from ``generator`` (a
    ``torch.Generator`` or ``RowDraws``)."""
    if u is not None:
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniform draws of shape {tuple(u.shape)}, "
                             f"want {tuple(shape)}")
        return u.to(device)
    if generator is None:
        raise ValueError("pass the uniform draws or a torch.Generator")
    if isinstance(generator, RowDraws):
        full = torch.rand((generator.batch,) + tuple(shape[1:]),
                          generator=generator.generator,
                          device=generator.generator.device)
        return full[generator.rows].to(device)
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def _random_cap_mask(mask: torch.Tensor, cap: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """Keep at most ``cap`` [B] True entries per row of ``mask`` [B, N]:
    those of highest draw ``u`` (JAX ``_random_cap_mask``: rank under a
    stable descending sort)."""
    score = torch.where(mask, u, torch.full_like(u, NEG))
    order = torch.sort(-score, dim=1, stable=True).indices
    n = mask.shape[1]
    ar = torch.arange(n, device=mask.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, ar)
    return mask & (rank < cap[:, None])


def anchor_targets(all_anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_valid: torch.Tensor, image_hw: Tuple[int, int],
                   rpn_batch_per_im: int = 256, fg_ratio: float = 0.5,
                   pos_thres: float = 0.7, neg_thres: float = 0.3,
                   u_fg: Optional[torch.Tensor] = None,
                   u_bg: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Label a flat anchor set against padded gt, per image.

    all_anchors [NA, 4], gt_boxes [B, G, 4] x1y1x2y2 (padded rows
    arbitrary), gt_valid [B, G] bool; u_fg, u_bg [B, NA] uniform draws (or
    ``generator``). Returns labels [B, NA] in {-1, 0, 1} and target gt boxes
    [B, NA, 4] (zeros for non-fg)."""
    h, w = image_hw
    b, na = gt_boxes.shape[0], all_anchors.shape[0]
    dev = gt_boxes.device
    inside = ((all_anchors[:, 0] >= 0) & (all_anchors[:, 1] >= 0)
              & (all_anchors[:, 2] <= w) & (all_anchors[:, 3] <= h))

    iou = pairwise_iou(all_anchors.expand(b, na, 4), gt_boxes)   # [B, NA, G]
    neg1 = torch.full_like(iou, -1.0)
    iou = torch.where(gt_valid[:, None, :], iou, neg1)
    iou = torch.where(inside[None, :, None], iou, neg1)
    del neg1

    iou_max, iou_argmax = iou.max(dim=2)
    # anchors attaining each gt's best IOU (ties included, like np.where ==)
    iou_max_per_gt = iou.max(dim=1, keepdim=True).values        # [B, 1, G]
    is_best = ((iou == iou_max_per_gt) & gt_valid[:, None, :]
               & (iou > 0)).any(dim=2)
    del iou

    labels = torch.full((b, na), -1, dtype=torch.int32, device=dev)
    labels = torch.where(iou_max < neg_thres, 0, labels)
    labels = torch.where(is_best | (iou_max >= pos_thres), 1, labels)
    labels = torch.where(inside[None, :], labels, -1)

    u_fg = _uniform(u_fg, (b, na), generator, dev)
    u_bg = _uniform(u_bg, (b, na), generator, dev)
    target_fg = int(rpn_batch_per_im * fg_ratio)
    fg_mask = _random_cap_mask(labels == 1, torch.full(
        (b,), target_fg, device=dev), u_fg)
    num_fg = fg_mask.sum(1)
    bg_mask = _random_cap_mask(labels == 0, rpn_batch_per_im - num_fg, u_bg)
    labels = torch.where(labels == 1, torch.where(fg_mask, 1, -1), labels)
    labels = torch.where(labels == 0, torch.where(bg_mask, 0, -1), labels)

    matched = torch.gather(gt_boxes, 1,
                           iou_argmax[..., None].expand(b, na, 4))
    target_boxes = torch.where((labels == 1)[..., None], matched,
                               torch.zeros_like(matched))
    return labels, target_boxes


def sample_fastrcnn_targets(proposals: torch.Tensor, prop_valid: torch.Tensor,
                            gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                            gt_valid: torch.Tensor, batch_per_im: int = 512,
                            fg_ratio: float = 0.25, fg_thres: float = 0.5,
                            u_fg: Optional[torch.Tensor] = None,
                            u_bg: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> Dict[str, torch.Tensor]:
    """Sample padded RoI training targets per image (nn.py:1119-1176).

    proposals [B, K, 4], prop_valid [B, K], gt_* [B, G, ...]; u_fg, u_bg
    [B, K + G] uniform draws (or ``generator``). Returns a dict of boxes
    [B, S, 4], labels [B, S] (0 = bg), valid [B, S], fg [B, S], fg_gt_boxes
    [B, S, 4] and fg_gt_idx [B, S] (the matched gt of fg rows, 0 otherwise;
    fg rows are packed first), S = fg_cap + bg_cap."""
    boxes = torch.cat([proposals, gt_boxes], dim=1)              # [B, K+G, 4]
    valid = torch.cat([prop_valid, gt_valid], dim=1)
    iou = pairwise_iou(boxes, gt_boxes)                          # [B, K+G, G]
    b, g = gt_boxes.shape[:2]
    k = proposals.shape[1]
    dev = boxes.device
    iou[:, k:, :] = torch.eye(g, dtype=iou.dtype, device=dev)   # gt rows
    neg1 = torch.full_like(iou, -1.0)
    iou = torch.where(gt_valid[:, None, :], iou, neg1)
    iou = torch.where(valid[:, :, None], iou, neg1)

    iou_max, best_gt = iou.max(dim=2)
    fg_mask = (iou_max >= fg_thres) & valid
    bg_mask = (~fg_mask) & valid & (iou_max >= 0)

    n_cand = boxes.shape[1]
    fg_cap = min(int(batch_per_im * fg_ratio), n_cand)
    bg_cap = min(batch_per_im - fg_cap, n_cand)
    u_fg = _uniform(u_fg, (b, n_cand), generator, dev)
    u_bg = _uniform(u_bg, (b, n_cand), generator, dev)

    def select(mask, cap, u):
        score = torch.where(mask, u, torch.full_like(u, NEG))
        vals, idx = sort_desc_stable(score, cap)
        return idx, vals > NEG / 2

    fg_idx, fg_ok = select(fg_mask, fg_cap, u_fg)
    bg_idx, bg_ok = select(bg_mask, bg_cap, u_bg)
    sel_idx = torch.cat([fg_idx, bg_idx], dim=1)
    sel_ok = torch.cat([fg_ok, bg_ok], dim=1)
    sel_fg = torch.cat([fg_ok, torch.zeros_like(bg_ok)], dim=1)

    picked = torch.gather(boxes, 1, sel_idx[..., None].expand(-1, -1, 4))
    sel_boxes = torch.where(sel_ok[..., None], picked,
                            torch.zeros_like(picked))
    sel_gt = torch.gather(best_gt, 1, sel_idx)
    labels = torch.where(sel_fg, torch.gather(gt_labels, 1, sel_gt).to(
        torch.int32), 0)
    labels = torch.where(sel_ok, labels, 0)
    gt_rows = torch.gather(gt_boxes, 1, sel_gt[..., None].expand(-1, -1, 4))
    fg_gt_boxes = torch.where(sel_fg[..., None], gt_rows,
                              torch.zeros_like(gt_rows))
    return {
        "boxes": sel_boxes,
        "labels": labels,
        "valid": sel_ok,
        "fg": sel_fg,
        "fg_gt_boxes": fg_gt_boxes,
        "fg_gt_idx": torch.where(sel_fg, sel_gt, 0).to(torch.int32),
    }


def effdet_anchor_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                          gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                          match_threshold: float = 0.5):
    """EfficientDet's AnchorLabeler (automl efficientdet/anchors.py:540):
    an ArgMax matcher whose match and unmatched thresholds are equal (no
    ignore band), with force_match_for_each_row: every valid gt claims its
    best anchor even below the threshold.

    anchors [N, 4] x1y1x2y2; gt_boxes [B, G, 4], gt_labels [B, G],
    gt_valid [B, G] (padded rows arbitrary). Returns (cls_targets [B, N]
    int32, 0 = background, else the gt label; box_targets [B, N, 4] (ty,
    tx, th, tw), zero off fg; fg [B, N] bool).

    JAX's force match is ``forced.at[best_anchor_per_gt].set(...)``, one
    write per gt row, an invalid row writing -1 (its IoU column is all -1,
    so its best anchor is anchor 0). Several rows can name one anchor, and
    JAX's scatter keeps the last row's write. Here that rule is explicit:
    per anchor the highest gt row that names it (``scatter_reduce`` amax)
    decides, invalid rows included, so CUDA gives the same answer as the
    CPU. Every argmax takes the first index on ties, as JAX's does."""
    from ..models.efficientdet.anchors import encode_effdet_boxes

    b, g = gt_valid.shape
    n = anchors.shape[0]
    iou = pairwise_iou(anchors, gt_boxes)                 # [B, N, G]
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    iou_max, iou_argmax = iou.max(dim=2)                  # [B, N]

    best_anchor = iou.argmax(dim=1)                       # [B, G]
    rows = torch.arange(g, device=iou.device).expand(b, g)
    writer = torch.full((b, n), -1, dtype=torch.long, device=iou.device)
    writer = writer.scatter_reduce(1, best_anchor, rows, "amax")
    writer_valid = torch.gather(gt_valid, 1, writer.clamp_min(0))
    forced = writer_valid & (writer >= 0)
    matched = torch.where(forced, writer, iou_argmax)
    fg = forced | (iou_max >= match_threshold)

    labels = torch.gather(gt_labels.long(), 1, matched)
    cls_targets = torch.where(fg, labels, 0).to(torch.int32)
    gt_rows = torch.gather(gt_boxes, 1, matched[..., None].expand(b, n, 4))
    enc = encode_effdet_boxes(gt_rows, anchors)
    box_targets = torch.where(fg[..., None], enc, torch.zeros_like(enc))
    return cls_targets, box_targets, fg
