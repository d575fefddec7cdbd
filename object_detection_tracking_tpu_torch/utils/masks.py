"""Mask post-processing: paste a 28x28 head output into the full frame and
encode COCO-compatible compressed RLE (the port's copy of
object_detection_tracking_tpu/utils/masks.py ``fill_full_mask``,
``polys_to_box_mask``, ``rle_encode``, ``rle_decode``).

The RLE codec follows pycocotools' maskApi.c format: column-major run
lengths, delta-encoded from the second-previous count, 5-bit LEB128-style
chars offset by 48. Only ``polys_to_box_mask`` (COCO training masks,
data/coco.py) needs cv2: ``fill_full_mask`` resizes with numpy as
``cv2.resize`` does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _linear_taps(n_src: int, n_dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """cv2 INTER_LINEAR's source index and float32 weight of the next
    source pixel for each output position along one axis: half-pixel
    centres in float64, the weight rounded once to float32, 0 at a clamped
    edge."""
    f = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
    i = np.floor(f)
    w = (f - i).astype(np.float32)
    i = i.astype(np.int64)
    edge = (i < 0) | (i >= n_src - 1)
    w[edge] = 0
    return np.clip(i, 0, n_src - 1), w


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add a * b + c, rounded once: the product is
    exact in float64, and the sum's float64 rounding error (TwoSum) breaks
    the ties a second rounding would get wrong."""
    p = a.astype(np.float64) * b
    c = c.astype(np.float64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf),
                                     np.float32(-np.inf)).astype(np.float32))
    tie = (s == (r.astype(np.float64) + other) / 2) & (err != 0)
    up, down = np.maximum(r, other), np.minimum(r, other)
    return np.where(tie, np.where(err > 0, up, down), r)


def resize_linear(src: np.ndarray, w: int, h: int) -> np.ndarray:
    """``cv2.resize(src, (w, h))`` (INTER_LINEAR) of a 2-D float32 array,
    bit for bit: the horizontal pass, then the vertical one, each output
    ``s0 + (s1 - s0) * weight`` in one float32 fused multiply-add."""
    src = np.asarray(src, np.float32)
    sh, sw = src.shape
    xi, xw = _linear_taps(sw, w)
    yi, yw = _linear_taps(sh, h)
    s0 = src[:, xi]
    rows = _fma32(src[:, np.minimum(xi + 1, sw - 1)] - s0, xw, s0)
    r0 = rows[yi]
    return _fma32(rows[np.minimum(yi + 1, sh - 1)] - r0, yw[:, None], r0)


def fill_full_mask(box_xyxy, mask: np.ndarray, im_hw) -> np.ndarray:
    """Paste an MxM soft mask into the full image (reference
    nn.py:1565-1586): int-coordinate box, bilinear resize, 0.5
    threshold."""
    x0, y0 = int(box_xyxy[0] + 0.5), int(box_xyxy[1] + 0.5)
    x1, y1 = int(box_xyxy[2] - 0.5), int(box_xyxy[3] - 0.5)
    x1, y1 = max(x0, x1), max(y0, y1)
    h_im, w_im = im_hw
    x0, y0 = min(x0, w_im - 1), min(y0, h_im - 1)
    x1, y1 = min(x1, w_im - 1), min(y1, h_im - 1)
    w = x1 + 1 - x0
    h = y1 + 1 - y0
    resized = resize_linear(mask, w, h)
    out = np.zeros((h_im, w_im), np.uint8)
    out[y0:y1 + 1, x0:x1 + 1] = (resized > 0.5).astype(np.uint8)
    return out


def polys_to_box_mask(polygons, box_xyxy, mask_size: int = 28,
                      supersample: int = 2) -> np.ndarray:
    """Rasterize COCO polygons onto a gt box's local MxM grid.

    This is the TPU-static gt-mask representation consumed by the mask
    training loss (train/losses.crop_mask_to_roi): the reference instead
    rasterizes to full image resolution and crops per proposal with
    crop_and_resize (models.py:744-776). Rasterizes at ``supersample``x
    resolution and box-average-thresholds for sub-pixel fidelity.

    polygons: list of flat [x1, y1, x2, y2, ...] image-coord lists.
    Returns float32 [mask_size, mask_size] in {0, 1}."""
    x1, y1, x2, y2 = [float(v) for v in box_xyxy]
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    ss = mask_size * supersample
    canvas = np.zeros((ss, ss), np.uint8)
    pts = []
    for poly in polygons:
        p = np.asarray(poly, np.float32).reshape(-1, 2)
        p[:, 0] = (p[:, 0] - x1) / w * ss
        p[:, 1] = (p[:, 1] - y1) / h * ss
        pts.append(np.round(p).astype(np.int32))
    if pts:
        cv2.fillPoly(canvas, pts, 1)
    if supersample > 1:
        canvas = canvas.reshape(mask_size, supersample,
                                mask_size, supersample).mean(axis=(1, 3))
    return (canvas >= 0.5).astype(np.float32)


def _counts(mask: np.ndarray) -> List[int]:
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return [0]
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    lengths = np.diff(bounds).tolist()
    if flat[0] == 1:
        lengths = [0] + lengths
    return lengths


def rle_encode(mask: np.ndarray) -> Dict:
    """binary mask [H, W] -> {"size": [H, W], "counts": str}."""
    h, w = mask.shape
    cnts = _counts(mask)
    chars = []
    for i, c in enumerate(cnts):
        x = int(c)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            chars.append(chr(48 + ch))
    return {"size": [h, w], "counts": "".join(chars)}


def rle_decode(rle: Dict) -> np.ndarray:
    """{"size": [H, W], "counts": str} -> binary mask [H, W] uint8."""
    h, w = rle["size"]
    s = rle["counts"]
    cnts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in cnts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape((h, w), order="F")
