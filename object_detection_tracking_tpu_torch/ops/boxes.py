"""Box utilities: IOU, decode, clipping, resize geometry (port of
object_detection_tracking_tpu/ops/boxes.py).

Tensor functions take torch tensors and broadcast over leading dims; the
``_np`` functions and the tlwh/xyxy helpers are the JAX module's host numpy
code, unchanged. Numerics follow the reference TF graph ops:
  * decode:        nn.py:1518-1541 (center-offset + log-wh, decode clip)
  * encode:        nn.py:1588-1616 (its inverse, for training targets)
  * clip_boxes:    nn.py:1339-1346 (clip x to W, y to H — not W-1/H-1)
  * pairwise_iou:  nn.py:675-700 (continuous area, no +1)
  * get_new_hw:    nn.py:1548-1560 (short-edge resize with max cap)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IOU [..., N, M] between x1y1x2y2 box sets [..., N, 4], [..., M, 4]."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    w = (torch.minimum(b1[..., 2], b2[..., 2])
         - torch.maximum(b1[..., 0], b2[..., 0])).clamp_min(0.0)
    h = (torch.minimum(b1[..., 3], b2[..., 3])
         - torch.maximum(b1[..., 1], b2[..., 1])).clamp_min(0.0)
    inter = w * h
    a1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    a2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _pairwise_intersection_np(boxes1, boxes2):
    x1 = np.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    y1 = np.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    x2 = np.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    y2 = np.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    return np.maximum(x2 - x1, 0.0) * np.maximum(y2 - y1, 0.0)


def _box_area_np(boxes):
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def pairwise_iou_np(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    boxes1 = np.asarray(boxes1, np.float64)
    boxes2 = np.asarray(boxes2, np.float64)
    inter = _pairwise_intersection_np(boxes1, boxes2)
    union = (_box_area_np(boxes1)[:, None] + _box_area_np(boxes2)[None, :]
             - inter)
    out = np.zeros_like(inter)
    np.divide(inter, union, out=out, where=union > 0)
    return out


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 decode_clip: float) -> torch.Tensor:
    """Apply (tx,ty,tw,th) deltas to x1y1x2y2 anchors; shapes broadcast over
    leading dims (JAX ops/boxes.py:65-79)."""
    txy = deltas[..., 0:2]
    twh = deltas[..., 2:4]
    a_x1y1 = anchors[..., 0:2]
    a_x2y2 = anchors[..., 2:4]
    waha = a_x2y2 - a_x1y1
    xaya = (a_x2y2 + a_x1y1) * 0.5
    wbhb = torch.exp(torch.clamp(twh, max=decode_clip)) * waha
    xbyb = txy * waha + xaya
    return torch.cat([xbyb - wbhb * 0.5, xbyb + wbhb * 0.5], dim=-1)


def encode_boxes(target: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of decode_boxes: (tx,ty,tw,th) of x1y1x2y2 ``target`` against
    ``anchors``, broadcast over leading dims (JAX ops/boxes.py:82-95)."""
    a_x1y1 = anchors[..., 0:2]
    a_x2y2 = anchors[..., 2:4]
    waha = a_x2y2 - a_x1y1
    xaya = (a_x2y2 + a_x1y1) * 0.5
    t_x1y1 = target[..., 0:2]
    t_x2y2 = target[..., 2:4]
    wghg = t_x2y2 - t_x1y1
    xgyg = (t_x2y2 + t_x1y1) * 0.5
    txy = (xgyg - xaya) / waha
    twh = torch.log(wghg / waha)
    return torch.cat([txy, twh], dim=-1)


def clip_boxes(boxes: torch.Tensor, hw) -> torch.Tensor:
    """Clip x1y1x2y2 boxes into [0,W]x[0,H] (JAX ops/boxes.py:111-117)."""
    h, w = hw
    # filled on the device: no host copy, no sync
    hi = torch.full((4,), float(w), dtype=boxes.dtype, device=boxes.device)
    hi[1::2] = float(h)
    return torch.minimum(boxes.clamp_min(0.0), hi)


def get_new_hw(h: int, w: int, size: int, max_size: int) -> Tuple[int, int]:
    """Short-edge target resize with long-edge cap; returns (new_w, new_h)
    like the reference (nn.py:1548-1560)."""
    scale = size * 1.0 / min(h, w)
    if h < w:
        newh, neww = size, scale * w
    else:
        newh, neww = scale * h, size
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh = newh * scale
        neww = neww * scale
    return int(neww + 0.5), int(newh + 0.5)


# --------------------------------------------------------------------------
# Format conversions (tracker interop; host numpy)


def xyxy_to_tlwh(boxes: np.ndarray) -> np.ndarray:
    boxes = np.asarray(boxes, np.float32).copy()
    boxes[..., 2] -= boxes[..., 0]
    boxes[..., 3] -= boxes[..., 1]
    return boxes


def tlwh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    boxes = np.asarray(boxes, np.float32).copy()
    boxes[..., 2] += boxes[..., 0]
    boxes[..., 3] += boxes[..., 1]
    return boxes


def tlwh_to_xyah(boxes: np.ndarray) -> np.ndarray:
    """top-left-wh -> center-x, center-y, aspect(w/h), height."""
    boxes = np.asarray(boxes, np.float32).copy()
    out = boxes.copy()
    out[..., 0] = boxes[..., 0] + boxes[..., 2] / 2.0
    out[..., 1] = boxes[..., 1] + boxes[..., 3] / 2.0
    out[..., 2] = boxes[..., 2] / np.maximum(boxes[..., 3], 1e-6)
    out[..., 3] = boxes[..., 3]
    return out
