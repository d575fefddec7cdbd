"""Image-list dataset for batch inference (reference datasets.py:13-79)."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from ..ops.boxes import get_new_hw


class ImageDataset:
    """imread + short-edge resize; batches group images of one (H, W)."""

    def __init__(self, img_paths: Sequence[str], short_edge_size: int,
                 max_size: int, batch_size: int = 1):
        self.img_paths = list(img_paths)
        self.short_edge_size = short_edge_size
        self.max_size = max_size
        self.batch_size = batch_size
        self.num_samples = len(self.img_paths)

    def get_sample(self, idx: int) -> Dict:
        path = self.img_paths[idx]
        im = cv2.imread(path, cv2.IMREAD_COLOR)
        if im is None:
            raise IOError(f"failed to read image {path}")
        h, w = im.shape[:2]
        neww, newh = get_new_hw(h, w, self.short_edge_size, self.max_size)
        if (neww, newh) != (w, h):
            im = cv2.resize(im, (neww, newh), interpolation=cv2.INTER_LINEAR)
        scale = (newh * 1.0 / h + neww * 1.0 / w) / 2.0
        return {
            "img": im,
            "img_name": os.path.basename(path),
            "img_path": path,
            "scale": scale,
            "orig_hw": (h, w),
        }

    def collect_batch(self, samples: List[Dict]) -> Dict:
        # pad to the max extent in the batch so one static shape serves all
        hmax = max(s["img"].shape[0] for s in samples)
        wmax = max(s["img"].shape[1] for s in samples)
        imgs = np.zeros((len(samples), hmax, wmax, 3), np.uint8)
        for i, s in enumerate(samples):
            h, w = s["img"].shape[:2]
            imgs[i, :h, :w] = s["img"]
        return {
            "imgs": imgs,
            "img_names": [s["img_name"] for s in samples],
            "img_paths": [s.get("img_path") for s in samples],
            "scales": [s["scale"] for s in samples],
            "orig_hws": [s["orig_hw"] for s in samples],
        }
