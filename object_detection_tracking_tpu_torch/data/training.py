"""Training data loading (reference main.py read_data_diva:737-1019).

Layout: a frame-name lst file, a frame image dir (2-level
``<videoname>/<framename>.jpg`` or flat), and per-frame ``.npz`` annotations
with ``boxes`` [G, 4] x1y1x2y2 and ``labels`` (strings or ids). Batches are
padded to a fixed max_gt with validity masks (static shapes for the jit
train step).
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..ops.boxes import get_new_hw


def _find_image(framepath: str, name: str) -> Optional[str]:
    base = os.path.splitext(name)[0]
    video = base.split("_F_")[0] if "_F_" in base else None
    candidates = [os.path.join(framepath, base + ext)
                  for ext in (".jpg", ".png", ".jpeg")]
    if video:
        candidates += [os.path.join(framepath, video, base + ext)
                       for ext in (".jpg", ".png", ".jpeg")]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


class DetectionTrainDataset:
    """Iterable over (images [B,H,W,3], gt_boxes [B,G,4], gt_labels [B,G],
    gt_valid [B,G]) batches."""

    def __init__(self, lst_file: str, framepath: str, annopath: str,
                 classname2id: Dict[str, int], short_edge_size: int,
                 max_size: int, batch_size: int = 1, max_gt: int = 100,
                 shuffle: bool = True, seed: int = 0,
                 flip_prob: float = 0.5, use_mixup: bool = False,
                 with_masks: bool = False, mask_size: int = 28,
                 short_edge_jitter=None, act_as_obj: bool = False,
                 act_mapping: Optional[Dict[str, str]] = None):
        with open(lst_file) as f:
            names = [l.strip() for l in f if l.strip()]
        self.samples = []
        for name in names:
            img = _find_image(framepath, name)
            anno = os.path.join(annopath,
                                os.path.splitext(name)[0] + ".npz")
            if img and os.path.exists(anno):
                self.samples.append((img, anno))
        self.classname2id = classname2id
        self.short_edge_size = short_edge_size
        self.max_size = max_size
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.flip_prob = flip_prob
        # mixup (reference models.py get_feed_dict mixup branch): blend two
        # frames with a Beta(1.5, 1.5) weight and take the union of boxes
        self.use_mixup = use_mixup
        # scale-jitter augmentation (ref models.py:1522-1524: short edge
        # ~ U[min, max] per image at train time). Batches then pad to a
        # monotonically-growing canvas so XLA recompiles only on growth
        # (a handful of times), not per batch.
        self.short_edge_jitter = short_edge_jitter
        self._canvas = None
        # instance masks for Mask-RCNN training: box-local [G, ms, ms]
        # rasterizations (npz key "masks"; COCO polygons rasterized by the
        # CocoTrainDataset subclass)
        self.with_masks = with_masks
        self.mask_size = mask_size
        # activity-box training (reference main.py:535-548): feed the
        # frame's activity boxes/labels as the object annotations, so the
        # same detector trains on the activity taxonomy (ACTIVITY_BOX.md).
        # act_mapping optionally renames annotation classnames into the
        # target taxonomy first (bupt_act_mapping, main.py:825-833).
        self.act_as_obj = act_as_obj
        self.act_mapping = act_mapping or {}
        self.rng = random.Random(seed)
        self.num_samples = len(self.samples)

    def _load_one(self, img_path: str, anno_path: str, flip: bool):
        im = cv2.imread(img_path, cv2.IMREAD_COLOR)
        h, w = im.shape[:2]
        se = self.short_edge_size
        if self.short_edge_jitter is not None and self.shuffle:
            lo, hi = self.short_edge_jitter
            se = self.rng.randint(lo, hi)
        neww, newh = get_new_hw(h, w, se, self.max_size)
        if (neww, newh) != (w, h):
            im = cv2.resize(im, (neww, newh), interpolation=cv2.INTER_LINEAR)
        sx, sy = neww / w, newh / h
        anno = dict(np.load(anno_path, allow_pickle=True))
        box_key, lab_key = ("actboxes", "actlabels") if self.act_as_obj \
            else ("boxes", "labels")
        boxes = np.asarray(anno[box_key], np.float32).reshape(-1, 4)
        boxes[:, 0::2] *= sx
        boxes[:, 1::2] *= sy
        labels = []
        for lab in anno[lab_key]:
            if isinstance(lab, bytes):
                lab = lab.decode()
            if isinstance(lab, str):
                lab = self.act_mapping.get(lab, lab)
                labels.append(self.classname2id.get(lab, -1))
            else:
                labels.append(int(lab))
        labels = np.asarray(labels, np.int32)
        masks = None
        if self.with_masks:
            ms = self.mask_size
            if "masks" in anno:
                masks = np.asarray(anno["masks"],
                                   np.float32).reshape(-1, ms, ms)
            else:
                masks = np.zeros((len(labels), ms, ms), np.float32)
        keep = labels > 0
        boxes, labels = boxes[keep], labels[keep]
        if masks is not None:
            masks = masks[keep]
        if flip:
            im = im[:, ::-1].copy()
            x1 = neww - boxes[:, 2]
            x2 = neww - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)
            if masks is not None:
                masks = masks[:, :, ::-1].copy()
        if masks is not None:
            return im, boxes, labels, masks
        return im, boxes, labels

    def batches(self, epochs: int = 1, pad_last: bool = False,
                yield_batch_valid: bool = False, pad_to=None):
        """Yield fixed-shape batches.

        pad_last: keep the final short batch by repeating its last sample
        (needed for full-coverage eval; training drops the remainder).
        yield_batch_valid: append a [B] bool mask marking real (non-pad)
        samples to each yield.
        pad_to: optional (H, W) to pad every image batch to — one XLA
        compile for the whole run instead of one per batch-max size.
        """
        for _ in range(epochs):
            order = list(range(self.num_samples))
            if self.shuffle:
                self.rng.shuffle(order)
            stop = len(order) if pad_last else \
                len(order) - self.batch_size + 1
            for s in range(0, stop, self.batch_size):
                idxs = order[s:s + self.batch_size]
                n_real = len(idxs)
                idxs = idxs + [idxs[-1]] * (self.batch_size - n_real)
                ims, gts, labs, msks = [], [], [], []
                for i in idxs:
                    flip = self.shuffle and \
                        self.rng.random() < self.flip_prob
                    loaded = self._load_one(*self.samples[i], flip)
                    im, b, l = loaded[:3]
                    m = loaded[3] if len(loaded) > 3 else None
                    if self.use_mixup:
                        j = self.rng.randrange(self.num_samples)
                        loaded2 = self._load_one(*self.samples[j], flip)
                        im2, b2, l2 = loaded2[:3]
                        lam = self.rng.betavariate(1.5, 1.5)
                        hmin = min(im.shape[0], im2.shape[0])
                        wmin = min(im.shape[1], im2.shape[1])
                        im = im[:hmin, :wmin]
                        im2 = im2[:hmin, :wmin]
                        im = (lam * im.astype(np.float32) +
                              (1 - lam) * im2.astype(np.float32)
                              ).astype(np.uint8)
                        b = np.concatenate([b, b2], axis=0)
                        l = np.concatenate([l, l2], axis=0)
                        if m is not None:
                            m = np.concatenate([m, loaded2[3]], axis=0)
                    ims.append(im)
                    gts.append(b)
                    labs.append(l)
                    msks.append(m)
                hmax = max(im.shape[0] for im in ims)
                wmax = max(im.shape[1] for im in ims)
                if pad_to is not None:
                    assert hmax <= pad_to[0] and wmax <= pad_to[1], \
                        ((hmax, wmax), pad_to)
                    hmax, wmax = pad_to
                elif self.short_edge_jitter is not None:
                    # grow-only canvas: jittered sizes vary per batch
                    if self._canvas is None:
                        self._canvas = (hmax, wmax)
                    self._canvas = (max(self._canvas[0], hmax),
                                    max(self._canvas[1], wmax))
                    hmax, wmax = self._canvas
                images = np.zeros((len(ims), hmax, wmax, 3), np.uint8)
                g = self.max_gt
                gt_boxes = np.zeros((len(ims), g, 4), np.float32)
                gt_labels = np.zeros((len(ims), g), np.int32)
                gt_valid = np.zeros((len(ims), g), bool)
                gt_masks = np.zeros(
                    (len(ims), g, self.mask_size, self.mask_size),
                    np.float32) if self.with_masks else None
                for bi, (im, b, l, m) in enumerate(
                        zip(ims, gts, labs, msks)):
                    images[bi, :im.shape[0], :im.shape[1]] = im
                    n = min(len(b), g)
                    gt_boxes[bi, :n] = b[:n]
                    gt_labels[bi, :n] = l[:n]
                    gt_valid[bi, :n] = True
                    if gt_masks is not None and m is not None:
                        gt_masks[bi, :n] = m[:n]
                parts = [images, gt_boxes, gt_labels, gt_valid]
                if gt_masks is not None:
                    parts.append(gt_masks)
                if yield_batch_valid:
                    parts.append(np.arange(len(ims)) < n_real)
                yield tuple(parts)
