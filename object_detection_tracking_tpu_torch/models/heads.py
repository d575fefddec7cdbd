"""Fast-RCNN 2-FC box head, class-specific and class-agnostic, and the
Mask R-CNN up-4-conv head (port of object_detection_tracking_tpu/models/
heads.py:60-130). The conv, attention and relation head variants are not
ported yet (ROADMAP A8).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .layers import Conv, conv2d, deconv2d, dense


class FastRCNN2FCHead(nn.Module):
    """Parameters ``fc6``, ``fc7``, ``outputs.class``, ``outputs.box`` as in
    the JAX tree. fc6 consumes [K, 7, 7, C] ROI features flattened y, x, c."""

    def __init__(self, num_class: int, feat_dim: int = 256, pool: int = 7,
                 fc_dim: int = 1024, class_agnostic: bool = False):
        super().__init__()
        self.num_class = num_class
        self.class_agnostic = class_agnostic
        self.fc6 = nn.Linear(pool * pool * feat_dim, fc_dim)
        self.fc7 = nn.Linear(fc_dim, fc_dim)
        num_box_class = 1 if class_agnostic else num_class
        self.outputs = nn.ModuleDict({
            "class": nn.Linear(fc_dim, num_class),
            "box": nn.Linear(fc_dim, num_box_class * 4),
        })

    def forward(self, feature: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feature [K, 7, 7, C] -> (class logits [K, num_class], box deltas
        [K, num_class-1 (or 1), 4]); the class-specific head drops the BG
        box row."""
        hidden = torch.relu(dense(self.fc6, feature))
        hidden = torch.relu(dense(self.fc7, hidden))
        classification = dense(self.outputs["class"], hidden)
        box = dense(self.outputs["box"], hidden)
        if self.class_agnostic:
            return classification, box.reshape(-1, 1, 4)
        return classification, box.reshape(-1, self.num_class, 4)[:, 1:, :]


class MaskRCNNUp4ConvHead(nn.Module):
    """Mask R-CNN head (JAX heads.py:106-130, reference models.py:
    1173-1202): four 3x3 convs with relu, a 2x2/2 deconv with relu, a 1x1
    to num_class-1 mask logits. Parameters ``fcn0..3``, ``deconv``,
    ``conv`` as in the JAX tree."""

    def __init__(self, num_class: int, feat_dim: int = 256,
                 head_dim: int = 256):
        super().__init__()
        c_in = feat_dim
        for k in range(4):
            setattr(self, f"fcn{k}", Conv(3, c_in, head_dim))
            c_in = head_dim
        self.deconv = Conv(2, head_dim, head_dim)
        self.conv = Conv(1, head_dim, num_class - 1)

    def forward(self, feature: torch.Tensor) -> torch.Tensor:
        """feature [K, 14, 14, C] NHWC -> mask logits [K, 28, 28,
        num_class-1]."""
        l = feature.permute(0, 3, 1, 2)
        for k in range(4):
            l = torch.relu(conv2d(getattr(self, f"fcn{k}"), l))
        l = torch.relu(deconv2d(self.deconv, l))
        return conv2d(self.conv, l).permute(0, 2, 3, 1)
