"""FPN neck and RPN head (port of object_detection_tracking_tpu/models/
fpn.py:36-86): lateral 1x1 convs, top-down nearest 2x upsample with the
overhang cropped, posthoc 3x3 convs, p6 = every other pixel of p5; with
``use_gn``, GroupNorm after each lateral (``gn_c*``) and after each 3x3
(``gn_p*``). The RPN head is a shared 3x3 conv + 1x1 class/box convs per
level. NCHW inside.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.norm import GroupNorm, group_norm
from .layers import Conv, conv2d, upsample2x_nearest


class FPN(nn.Module):
    def __init__(self, c_channels: Sequence[int] = (256, 512, 1024, 2048),
                 num_channel: int = 256, use_gn: bool = False):
        super().__init__()
        self.use_gn = use_gn
        for i, c in enumerate(c_channels):
            self.add_module(f"lateral_1x1_c{i + 2}", Conv(1, c, num_channel))
            self.add_module(f"posthoc_3x3_p{i + 2}",
                            Conv(3, num_channel, num_channel))
            if use_gn:
                self.add_module(f"gn_c{i + 2}", GroupNorm(num_channel))
                self.add_module(f"gn_p{i + 2}", GroupNorm(num_channel))

    def forward(self, c2345: List[torch.Tensor]) -> List[torch.Tensor]:
        """c2..c5 -> [p2, p3, p4, p5, p6]."""
        lat = [conv2d(getattr(self, f"lateral_1x1_c{i + 2}"), c)
               for i, c in enumerate(c2345)]
        if self.use_gn:
            lat = [group_norm(getattr(self, f"gn_c{i + 2}"), x)
                   for i, x in enumerate(lat)]
        acc = [lat[3]]
        for idx in range(2, -1, -1):
            up = upsample2x_nearest(acc[-1])
            h, w = lat[idx].shape[2:]
            acc.append(lat[idx] + up[:, :, :h, :w])
        acc = acc[::-1]
        p2345 = [conv2d(getattr(self, f"posthoc_3x3_p{i + 2}"), x)
                 for i, x in enumerate(acc)]
        if self.use_gn:
            p2345 = [group_norm(getattr(self, f"gn_p{i + 2}"), x)
                     for i, x in enumerate(p2345)]
        return p2345 + [p2345[-1][:, :, ::2, ::2]]


class RPNHead(nn.Module):
    """Parameters ``conv0``, ``class``, ``box`` as in the JAX tree."""

    def __init__(self, channel: int = 256, num_anchors: int = 3):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv0 = Conv(3, channel, channel)
        self.add_module("class", Conv(1, channel, num_anchors))
        self.box = Conv(1, channel, 4 * num_anchors)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat [B, C, FH, FW] -> (label_logits [B, FH, FW, A],
        box_logits [B, FH, FW, A, 4]), NHWC like the JAX head."""
        h = torch.relu(conv2d(self.conv0, feat))
        label = conv2d(getattr(self, "class"), h).permute(0, 2, 3, 1)
        box = conv2d(self.box, h).permute(0, 2, 3, 1)
        b, fh, fw, _ = box.shape
        return label, box.reshape(b, fh, fw, self.num_anchors, 4)
