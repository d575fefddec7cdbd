"""EfficientDet anchors, box encode and decode (port of
object_detection_tracking_tpu/models/efficientdet/anchors.py).

Per level L in [min_level, max_level]: 3 octave scales 2^(i/3), aspects
(1,1), (1.4, 0.7), (0.7, 1.4), base size anchor_scale * 2^L, centered on
stride/2. Box outputs are (ty, tx, th, tw) against (cy, cx, h, w) anchors:
y first, the opposite of the Faster R-CNN path. ``effdet_anchors`` is the
JAX module's numpy code, unchanged.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

OCTAVES = 3
ASPECTS = ((1.0, 1.0), (1.4, 0.7), (0.7, 1.4))


def effdet_anchors(image_size: Tuple[int, int], min_level: int = 3,
                   max_level: int = 7,
                   anchor_scale: float = 4.0) -> List[np.ndarray]:
    """Per-level anchor boxes [FH, FW, A, 4] x1y1x2y2 (A = 9)."""
    h, w = image_size
    out = []
    for level in range(min_level, max_level + 1):
        stride = 2 ** level
        fh = -(-h // stride)
        fw = -(-w // stride)
        base = anchor_scale * stride
        sizes = []
        for octave in range(OCTAVES):
            scale = 2 ** (octave / OCTAVES)
            for ax, ay in ASPECTS:
                sizes.append((base * scale * ax / 2.0,
                              base * scale * ay / 2.0))
        cx = (np.arange(fw) + 0.5) * stride
        cy = (np.arange(fh) + 0.5) * stride
        cxg, cyg = np.meshgrid(cx, cy)
        boxes = np.zeros((fh, fw, len(sizes), 4), np.float32)
        for ai, (hw, hh) in enumerate(sizes):
            boxes[:, :, ai, 0] = cxg - hw
            boxes[:, :, ai, 1] = cyg - hh
            boxes[:, :, ai, 2] = cxg + hw
            boxes[:, :, ai, 3] = cyg + hh
        out.append(boxes)
    return out


def decode_effdet_boxes(deltas: torch.Tensor,
                        anchors: torch.Tensor) -> torch.Tensor:
    """deltas [..., 4] = (ty, tx, th, tw); anchors [..., 4] x1y1x2y2 ->
    decoded x1y1x2y2 (automl anchors.py decode_box_outputs_tf)."""
    acx = (anchors[..., 0] + anchors[..., 2]) / 2.0
    acy = (anchors[..., 1] + anchors[..., 3]) / 2.0
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ty, tx, th, tw = deltas.unbind(-1)
    cy = ty * ah + acy
    cx = tx * aw + acx
    h = torch.exp(th) * ah
    w = torch.exp(tw) * aw
    return torch.stack([cx - w / 2.0, cy - h / 2.0,
                        cx + w / 2.0, cy + h / 2.0], dim=-1)


def encode_effdet_boxes(boxes: torch.Tensor,
                        anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of ``decode_effdet_boxes``: x1y1x2y2 boxes -> (ty, tx, th,
    tw) against the anchors, w and h floored at 1e-6 (automl's
    FasterRcnnBoxCoder in EfficientDet's y-first order). The logs are taken
    in float64 and rounded to float32, so that CUDA and the CPU give the
    same bits (their float32 logs may differ by an ulp)."""
    acx = (anchors[..., 0] + anchors[..., 2]) / 2.0
    acy = (anchors[..., 1] + anchors[..., 3]) / 2.0
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-6)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-6)

    def log(t):
        return torch.log(t.double()).to(t.dtype)
    return torch.stack([(cy - acy) / ah, (cx - acx) / aw,
                        log(h / ah), log(w / aw)], dim=-1)
