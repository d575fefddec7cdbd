"""Xception ReID net, ``xception`` (port of
object_detection_tracking_tpu/models/reid/xception_reid.py:1-79), built as
torchreid's xception.py builds it: an unpadded 3x3/2 ``conv1`` and 3x3
``conv2``, each with BN and ReLU; 12 blocks of depthwise-separable convs
(``conv1`` depthwise, ``pointwise`` 1x1) in ``rep``, with a 1x1 ``skip``
conv and ``skipbn`` where the block changes width or stride, and a 3x3/2
max pool ending each strided block; separable ``conv3`` (1536) and
``conv4`` (2048) with BN and ReLU; GAP features, 2048-d (torchreid
builds ``xception`` with no fc head).

A block's ``rep`` is torchreid's Sequential: [ReLU, SepConv, BN] per
separable conv (the widening one first with ``grow_first``, last
without), the leading ReLU dropped without ``start_with_relu``, so the
Sequential's indices, and the state_dict names, shift with both flags.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, init_params

# (in, out, reps, stride, start_with_relu, grow_first) per block
# (xception.py:168-206)
BLOCKS = ((64, 128, 2, 2, False, True), (128, 256, 2, 2, True, True),
          (256, 728, 2, 2, True, True)) \
    + ((728, 728, 3, 1, True, True),) * 8 \
    + ((728, 1024, 2, 2, True, False),)


class SeparableConv2d(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1,
                 padding: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_in, k, stride, padding, groups=c_in,
                               bias=False)
        self.pointwise = nn.Conv2d(c_in, c_out, 1, bias=False)

    def forward(self, x):
        return self.pointwise(self.conv1(x))


class Block(nn.Module):
    def __init__(self, c_in: int, c_out: int, reps: int, stride: int,
                 start_with_relu: bool, grow_first: bool):
        super().__init__()
        if c_out != c_in or stride != 1:
            self.skip = nn.Conv2d(c_in, c_out, 1, stride, bias=False)
            self.skipbn = nn.BatchNorm2d(c_out)
        else:
            self.skip = None
        rep, c = [], c_in
        if grow_first:
            rep += [nn.ReLU(), SeparableConv2d(c_in, c_out),
                    nn.BatchNorm2d(c_out)]
            c = c_out
        for _ in range(reps - 1):
            rep += [nn.ReLU(), SeparableConv2d(c, c), nn.BatchNorm2d(c)]
        if not grow_first:
            rep += [nn.ReLU(), SeparableConv2d(c_in, c_out),
                    nn.BatchNorm2d(c_out)]
        if not start_with_relu:
            rep = rep[1:]
        if stride != 1:
            rep.append(nn.MaxPool2d(3, stride, 1))
        self.rep = nn.Sequential(*rep)

    def forward(self, x):
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return self.rep(x) + skip


class XceptionReID(ReIDNet):
    """torchreid's ``xception`` without its classifier: images [B, 3, H, W]
    normalized RGB -> features [B, 2048] float32."""

    def __init__(self, name: str = "xception"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3, 2, 0, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        self.conv2 = nn.Conv2d(32, 64, 3, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        for i, cfg in enumerate(BLOCKS, start=1):
            setattr(self, f"block{i}", Block(*cfg))
        self.conv3 = SeparableConv2d(1024, 1536)
        self.bn3 = nn.BatchNorm2d(1536)
        self.conv4 = SeparableConv2d(1536, 2048)
        self.bn4 = nn.BatchNorm2d(2048)
        self.feature_dim = 2048
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for i in range(1, len(BLOCKS) + 1):
            x = getattr(self, f"block{i}")(x)
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.relu(self.bn4(self.conv4(x)))
        return x.mean((2, 3)).float()
