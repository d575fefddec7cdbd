"""COCO-json annotation adapter for training (reference main.py add_coco /
read_data_coco:721,1957 — without requiring pycocotools).

Reads a COCO instances json, maps COCO category names to the model's class
ids (optionally through class_ids.coco_obj_to_actev_obj for ActEV
fine-tuning), and exposes the same sample list contract as
DetectionTrainDataset.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from .training import DetectionTrainDataset


def load_coco_annotations(json_path: str, image_dir: str,
                          classname2id: Dict[str, int],
                          name_mapping: Optional[Dict[str, str]] = None):
    """-> list of (image_path, boxes [G, 4] x1y1x2y2, labels [G] int32)."""
    with open(json_path) as f:
        coco = json.load(f)
    cat_names = {c["id"]: c["name"] for c in coco["categories"]}
    images = {im["id"]: im for im in coco["images"]}
    per_image = defaultdict(list)
    for ann in coco["annotations"]:
        if ann.get("iscrowd", 0):
            continue
        name = cat_names.get(ann["category_id"])
        if name_mapping is not None:
            name = name_mapping.get(name)
        if name is None or name not in classname2id:
            continue
        x, y, w, h = ann["bbox"]
        seg = ann.get("segmentation")
        if not isinstance(seg, list):  # RLE crowd segs are filtered above
            seg = None
        per_image[ann["image_id"]].append(
            ((x, y, x + w, y + h, classname2id[name]), seg))
    samples = []
    for img_id, rows in per_image.items():
        info = images.get(img_id)
        if info is None:
            continue
        path = os.path.join(image_dir, info["file_name"])
        if not os.path.exists(path):
            continue
        arr = np.asarray([r for r, _ in rows], np.float32)
        segs = [s for _, s in rows]
        samples.append((path, arr[:, :4],
                        arr[:, 4].astype(np.int32), segs))
    return samples


class CocoTrainDataset(DetectionTrainDataset):
    """DetectionTrainDataset over a COCO instances json."""

    def __init__(self, json_path: str, image_dir: str,
                 classname2id: Dict[str, int], short_edge_size: int,
                 max_size: int, name_mapping: Optional[Dict[str, str]] = None,
                 **kw):
        # bypass the lst/npz discovery of the parent
        self.coco_samples = load_coco_annotations(
            json_path, image_dir, classname2id, name_mapping)
        self.samples = [(p, None) for p, _, _, _ in self.coco_samples]
        self.classname2id = classname2id
        self.short_edge_size = short_edge_size
        self.max_size = max_size
        self.batch_size = kw.get("batch_size", 1)
        self.max_gt = kw.get("max_gt", 100)
        self.shuffle = kw.get("shuffle", True)
        self.flip_prob = kw.get("flip_prob", 0.5)
        self.use_mixup = kw.get("use_mixup", False)
        self.with_masks = kw.get("with_masks", False)
        self.mask_size = kw.get("mask_size", 28)
        self.short_edge_jitter = kw.get("short_edge_jitter")
        self._canvas = None
        import random
        self.rng = random.Random(kw.get("seed", 0))
        self.num_samples = len(self.samples)

    def _load_one(self, img_path, _anno_path, flip):
        import cv2
        from ..ops.boxes import get_new_hw
        idx = next(i for i, (p, _, _, _) in enumerate(self.coco_samples)
                   if p == img_path)
        _, boxes, labels, segs = self.coco_samples[idx]
        boxes = boxes.copy()
        masks = None
        if self.with_masks:
            # rasterize polygons in ORIGINAL image coords against the
            # original box — box-local masks are scale-invariant, so the
            # resize below needs no mask work
            from ..utils.masks import polys_to_box_mask
            ms = self.mask_size
            masks = np.stack([
                polys_to_box_mask(seg, box, ms) if seg else
                np.zeros((ms, ms), np.float32)
                for seg, box in zip(segs, boxes)
            ]) if len(boxes) else np.zeros((0, ms, ms), np.float32)
        im = cv2.imread(img_path, cv2.IMREAD_COLOR)
        h, w = im.shape[:2]
        neww, newh = get_new_hw(h, w, self.short_edge_size, self.max_size)
        if (neww, newh) != (w, h):
            im = cv2.resize(im, (neww, newh), interpolation=cv2.INTER_LINEAR)
        boxes[:, 0::2] *= neww / w
        boxes[:, 1::2] *= newh / h
        if flip:
            im = im[:, ::-1].copy()
            x1 = neww - boxes[:, 2]
            x2 = neww - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)
            if masks is not None:
                masks = masks[:, :, ::-1].copy()
        if masks is not None:
            return im, boxes, labels.copy(), masks
        return im, boxes, labels.copy()
