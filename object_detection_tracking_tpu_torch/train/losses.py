"""Detection losses, batched over images (port of
object_detection_tracking_tpu/train/losses.py, masked static-shape versions
of the reference's models.py:1328-1466).

The JAX functions take one image and run under ``vmap``; here every
function takes a leading batch dimension B and returns per-image values
[B], which the model averages over the batch as JAX's ``.mean()`` does. All
reductions use validity masks; the normalizers are the reference's
(sum/rpn_batch_per_im for RPN, the mean over valid samples for the FRCNN
label loss, sum/valid samples for its box loss; huber delta 1/9 with the
reference's ``/delta`` rescale for RPN).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.boxes import encode_boxes


def huber(diff: torch.Tensor, delta: float) -> torch.Tensor:
    abs_d = diff.abs()
    quad = 0.5 * diff * diff
    lin = delta * (abs_d - 0.5 * delta)
    return torch.where(abs_d <= delta, quad, lin)


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.clamp_min(0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - picked


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """Per-element sigmoid focal loss (nn.py:1621-1640; sum over the last
    axes is the caller's job). labels are {0, 1} floats."""
    p = torch.sigmoid(logits.float())
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    pos_sub = torch.where(labels > 0, labels - p, zero)
    neg_sub = torch.where(labels > 0, zero, p)
    return (-alpha * (pos_sub ** gamma) * torch.log(p.clamp(1e-8, 1.0))
            - (1 - alpha) * (neg_sub ** gamma)
            * torch.log((1.0 - p).clamp(1e-8, 1.0)))


def _masked_sum(x: torch.Tensor, mask: torch.Tensor, dims) -> torch.Tensor:
    return torch.where(mask, x, torch.zeros_like(x)).sum(dim=dims)


def rpn_losses(anchor_labels: torch.Tensor, anchor_boxes: torch.Tensor,
               anchors: torch.Tensor, label_logits: torch.Tensor,
               box_logits: torch.Tensor, rpn_batch_per_im: int = 256,
               use_focal: bool = False) -> Dict[str, torch.Tensor]:
    """anchor_labels [B, N] in {-1, 0, 1}; anchor_boxes [B, N, 4] target gt
    boxes (fg rows); anchors [N, 4]; logits [B, N] / [B, N, 4]. Returns
    per-image losses [B]."""
    valid = anchor_labels != -1
    pos = anchor_labels == 1
    target = pos.float()
    if use_focal:
        lbl = focal_loss(label_logits.float(), target)
        label_loss = _masked_sum(lbl, valid, 1)
    else:
        lbl = sigmoid_ce(label_logits.float(), target)
        label_loss = _masked_sum(lbl, valid, 1) / rpn_batch_per_im

    enc_gt = encode_boxes(anchor_boxes, anchors)
    delta = 1.0 / 9
    bl = huber(box_logits.float() - enc_gt, delta)
    box_loss = _masked_sum(bl, pos[..., None], (1, 2)) / delta \
        / rpn_batch_per_im

    zero = torch.zeros((), dtype=label_loss.dtype, device=label_loss.device)
    return {
        "rpn_label_loss": torch.where(valid.sum(1) == 0, zero, label_loss),
        "rpn_box_loss": torch.where(pos.sum(1) == 0, zero, box_loss),
    }


def fastrcnn_losses(labels: torch.Tensor, label_logits: torch.Tensor,
                    enc_fg_boxes: torch.Tensor, box_logits: torch.Tensor,
                    valid: torch.Tensor, fg: torch.Tensor,
                    use_focal: bool = False) -> Dict[str, torch.Tensor]:
    """labels [B, S] (0 bg), label_logits [B, S, C], enc_fg_boxes [B, S, 4]
    encoded regression targets for fg rows, box_logits [B, S,
    num_box_class, 4], masks valid/fg [B, S]. Returns per-image losses
    [B]."""
    n_valid = valid.sum(1).clamp_min(1)
    if use_focal:
        onehot = F.one_hot(labels.long(), label_logits.shape[-1]).float()
        fl = focal_loss(label_logits.float(), onehot).sum(-1)
        label_loss = _masked_sum(fl, valid, 1)
    else:
        ce = softmax_ce(label_logits.float(), labels)
        label_loss = _masked_sum(ce, valid, 1) / n_valid

    if box_logits.shape[2] > 1:
        cls_idx = (labels.long() - 1).clamp_min(0)
        fg_box_logits = torch.gather(
            box_logits, 2,
            cls_idx[:, :, None, None].expand(-1, -1, 1, 4))[:, :, 0, :]
    else:
        fg_box_logits = box_logits[:, :, 0, :]
    bl = huber(fg_box_logits.float() - enc_fg_boxes, 1.0)
    box_loss = _masked_sum(bl, fg[..., None], (1, 2)) / n_valid
    return {"frcnn_label_loss": label_loss, "frcnn_box_loss": box_loss}


def crop_mask_to_roi(gt_mask: torch.Tensor, gt_box: torch.Tensor,
                     roi_box: torch.Tensor, out_size: int = 28
                     ) -> torch.Tensor:
    """Resample box-local gt masks onto roi boxes' out x out grids (JAX
    train/losses.py:110-152): each gt mask arrives rasterized on a fixed
    Ms x Ms grid over its own gt box, and is sampled bilinearly at the roi
    box's pixel centers mapped through the gt box extent.

    gt_mask [..., Ms, Ms] float {0,1}; gt_box, roi_box [..., 4] x1y1x2y2
    image coords. Returns [..., out, out] float in [0, 1]."""
    ms = gt_mask.shape[-1]
    gx1, gy1, gx2, gy2 = gt_box.unbind(-1)
    rx1, ry1, rx2, ry2 = roi_box.unbind(-1)
    gw = (gx2 - gx1).clamp_min(1e-4)
    gh = (gy2 - gy1).clamp_min(1e-4)
    i = torch.arange(out_size, dtype=torch.float32, device=gt_mask.device)
    ys = ry1[..., None] + (i + 0.5) * (ry2 - ry1)[..., None] / out_size
    xs = rx1[..., None] + (i + 0.5) * (rx2 - rx1)[..., None] / out_size
    u = (ys - gy1[..., None]) / gh[..., None] * ms - 0.5
    v = (xs - gx1[..., None]) / gw[..., None] * ms - 0.5

    def sample_axis(c):
        c0 = torch.floor(c)
        frac = c - c0
        i0 = c0.long().clamp(0, ms - 1)
        i1 = (i0 + 1).clamp(0, ms - 1)
        inb = (c > -0.5 - 1e-6) & (c < ms - 0.5 + 1e-6)
        return i0, i1, frac, inb

    y0, y1, fy, in_y = sample_axis(u)
    x0, x1, fx, in_x = sample_axis(v)
    m = gt_mask.float()

    def take(yi, xi):
        rows = torch.gather(m, -2, yi[..., :, None].expand(
            *yi.shape, ms))                                # [..., out, Ms]
        return torch.gather(rows, -1, xi[..., None, :].expand(
            *yi.shape, out_size))                          # [..., out, out]

    fx_ = fx[..., None, :]
    fy_ = fy[..., :, None]
    top = take(y0, x0) * (1 - fx_) + take(y0, x1) * fx_
    bot = take(y1, x0) * (1 - fx_) + take(y1, x1) * fx_
    out = top * (1 - fy_) + bot * fy_
    inside = in_y[..., :, None] & in_x[..., None, :]
    return torch.where(inside, out, torch.zeros_like(out))


def maskrcnn_loss(mask_logits: torch.Tensor, labels: torch.Tensor,
                  fg: torch.Tensor, mask_targets: torch.Tensor
                  ) -> torch.Tensor:
    """Mask head loss (models.py:1307-1326): the per-class channel gathered
    by each fg row's label, mean per-pixel sigmoid CE over fg rows.

    mask_logits [B, S, 28, 28, C-1]; labels [B, S] (1..C-1 on fg rows); fg
    [B, S]; mask_targets [B, S, 28, 28] float {0,1}. Returns per-image
    losses [B]."""
    cls_idx = (labels.long() - 1).clamp(0, mask_logits.shape[-1] - 1)
    b, s, h, w, _ = mask_logits.shape
    picked = torch.gather(
        mask_logits, -1,
        cls_idx[:, :, None, None, None].expand(b, s, h, w, 1))[..., 0]
    ce = sigmoid_ce(picked.float(), mask_targets.float())
    per_roi = ce.mean(dim=(2, 3))
    n_fg = fg.sum(1).clamp_min(1)
    loss = _masked_sum(per_roi, fg, 1) / n_fg
    return torch.where(fg.any(1), loss, torch.zeros_like(loss))
