"""Fast-RCNN box head, class-specific and class-agnostic, with its
variants, and the Mask R-CNN up-4-conv head (port of
object_detection_tracking_tpu/models/heads.py:20-130).

The box head's variants (JAX heads.py:20-104): the 4-conv head with one
fc (``use_conv_head``) in place of fc6/fc7; relation-network residuals
after fc6 and fc7 (``add_relation_nn``: ``RM_r1``/``RM_r2``, each image's
boxes attending within the image, models/relation.py); the attention
branch (``use_att_head``: a 3x3 conv to one spatial logit, softmax over the
7x7 positions, the attended feature through ``att_trans``, added to the
hidden state).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import Conv, conv2d, deconv2d, dense
from .relation import Relation, relation_network


class FastRCNN2FCHead(nn.Module):
    """Parameters ``fc6``, ``fc7`` (or ``conv0..3`` and ``fc``),
    ``outputs.class``, ``outputs.box`` and the options' ``RM_r1``,
    ``RM_r2``, ``attention``, ``att_trans`` as in the JAX tree. fc6 (and
    the conv head's fc) consume [K, 7, 7, C] features flattened y, x, c."""

    def __init__(self, num_class: int, feat_dim: int = 256, pool: int = 7,
                 fc_dim: int = 1024, class_agnostic: bool = False,
                 add_relation_nn: bool = False, use_att_head: bool = False,
                 use_conv_head: bool = False, conv_dim: int = 256):
        super().__init__()
        self.num_class = num_class
        self.class_agnostic = class_agnostic
        self.use_conv_head = use_conv_head
        if use_conv_head:
            c_in = feat_dim
            for k in range(4):
                setattr(self, f"conv{k}", Conv(3, c_in, conv_dim))
                c_in = conv_dim
            self.fc = nn.Linear(pool * pool * conv_dim, fc_dim)
        else:
            self.fc6 = nn.Linear(pool * pool * feat_dim, fc_dim)
            self.fc7 = nn.Linear(fc_dim, fc_dim)
        num_box_class = 1 if class_agnostic else num_class
        self.outputs = nn.ModuleDict({
            "class": nn.Linear(fc_dim, num_class),
            "box": nn.Linear(fc_dim, num_box_class * 4),
        })
        # JAX draws RM_r1/RM_r2 under the conv head too, but only the fc
        # path applies them (JAX heads.py:69-86)
        self.add_relation_nn = add_relation_nn and not use_conv_head
        if add_relation_nn:
            self.RM_r1 = Relation(fc_dim)
            self.RM_r2 = Relation(fc_dim)
        if use_att_head:
            self.attention = Conv(3, feat_dim, 1)
            self.att_trans = nn.Linear(feat_dim, fc_dim)
        else:
            self.attention = None

    def forward(self, feature: torch.Tensor,
                boxes: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feature [K, 7, 7, C] -> (class logits [K, num_class], box deltas
        [K, num_class-1 (or 1), 4]); the class-specific head drops the BG
        box row. The relation residuals need ``boxes`` [B, K/B, 4] (the
        rows of ``feature`` image by image) and take ``valid`` [B, K/B]
        (ROADMAP C14)."""
        if not self.use_conv_head:
            hidden = torch.relu(dense(self.fc6, feature))
            if self.add_relation_nn:
                hidden = hidden + self._relation(self.RM_r1, hidden, boxes,
                                                 valid)
            hidden = torch.relu(dense(self.fc7, hidden))
            if self.add_relation_nn:
                hidden = hidden + self._relation(self.RM_r2, hidden, boxes,
                                                 valid)
        else:   # conv head (JAX heads.py:81-86)
            l = feature.permute(0, 3, 1, 2)
            for k in range(4):
                l = torch.relu(conv2d(getattr(self, f"conv{k}"), l))
            hidden = torch.relu(dense(self.fc, l.permute(0, 2, 3, 1)))

        if self.attention is not None:   # JAX heads.py:88-95
            k_, h_, w_, c_ = feature.shape
            att = conv2d(self.attention, feature.permute(0, 3, 1, 2))
            att = torch.softmax(att.reshape(k_, h_ * w_, 1), dim=1)
            attended = (feature.reshape(k_, h_ * w_, c_) * att).sum(dim=1)
            hidden = hidden + torch.relu(dense(self.att_trans, attended))

        classification = dense(self.outputs["class"], hidden)
        box = dense(self.outputs["box"], hidden)
        if self.class_agnostic:
            return classification, box.reshape(-1, 1, 4)
        return classification, box.reshape(-1, self.num_class, 4)[:, 1:, :]

    @staticmethod
    def _relation(p: Relation, hidden, boxes, valid):
        b, k = boxes.shape[:2]
        return relation_network(p, hidden.reshape(b, k, -1), boxes,
                                valid).reshape(b * k, -1)


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
