"""Inception-ResNet-v2 ReID net, ``inceptionresnetv2`` (port of
object_detection_tracking_tpu/models/reid/inceptionresnetv2_reid.py:
1-111), built as torchreid's inceptionresnetv2.py (the Cadene
pretrainedmodels graph) builds it: the unpadded stem ``conv2d_1a`` ..
``conv2d_4a`` with two 3x3/2 max pools; ``mixed_5b``; ``repeat``, 10
Block35 (residual scale 0.17); ``mixed_6a``; ``repeat_1``, 20 Block17
(0.10); ``mixed_7a``; ``repeat_2``, 9 Block8 (0.20); ``block8``, a Block8
at scale 1.0 without its ReLU; ``conv2d_7b``; GAP features, 1536-d.
BasicConv2d as in Inception-v4 (no conv bias, BN eps 1e-3); each block's
1x1 projection ``conv2d`` has a bias and no BN.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ReIDNet, init_params
from .inceptionv4_reid import BasicConv2d, max_pool_3_2, pool_branch, seq


class Mixed5b(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(192, 96, 1)
        self.branch1 = seq((192, 48, 1), (48, 64, 5, 1, 2))
        self.branch2 = seq((192, 64, 1), (64, 96, 3, 1, 1),
                           (96, 96, 3, 1, 1))
        self.branch3 = pool_branch(192, 64)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class Residual(nn.Module):
    """x + scale * conv2d(concat(branches)), then ReLU unless ``relu`` is
    False."""

    def __init__(self, scale: float, relu: bool = True):
        super().__init__()
        self.scale = scale
        self.relu = relu

    def forward(self, x):
        out = self.conv2d(torch.cat([getattr(self, f"branch{i}")(x)
                                     for i in range(self.n_branches)], 1))
        out = out * self.scale + x
        return torch.relu(out) if self.relu else out


class Block35(Residual):
    n_branches = 3

    def __init__(self, scale: float = 0.17):
        super().__init__(scale)
        self.branch0 = BasicConv2d(320, 32, 1)
        self.branch1 = seq((320, 32, 1), (32, 32, 3, 1, 1))
        self.branch2 = seq((320, 32, 1), (32, 48, 3, 1, 1),
                           (48, 64, 3, 1, 1))
        self.conv2d = nn.Conv2d(128, 320, 1)


class Block17(Residual):
    n_branches = 2

    def __init__(self, scale: float = 0.10):
        super().__init__(scale)
        self.branch0 = BasicConv2d(1088, 192, 1)
        self.branch1 = seq((1088, 128, 1), (128, 160, (1, 7), 1, (0, 3)),
                           (160, 192, (7, 1), 1, (3, 0)))
        self.conv2d = nn.Conv2d(384, 1088, 1)


class Block8(Residual):
    n_branches = 2

    def __init__(self, scale: float = 1.0, relu: bool = True):
        super().__init__(scale, relu)
        self.branch0 = BasicConv2d(2080, 192, 1)
        self.branch1 = seq((2080, 192, 1), (192, 224, (1, 3), 1, (0, 1)),
                           (224, 256, (3, 1), 1, (1, 0)))
        self.conv2d = nn.Conv2d(448, 2080, 1)


class Mixed6a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(320, 384, 3, 2)
        self.branch1 = seq((320, 256, 1), (256, 256, 3, 1, 1),
                           (256, 384, 3, 2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), max_pool_3_2(x)],
                         1)


class Mixed7a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = seq((1088, 256, 1), (256, 384, 3, 2))
        self.branch1 = seq((1088, 256, 1), (256, 288, 3, 2))
        self.branch2 = seq((1088, 256, 1), (256, 288, 3, 1, 1),
                           (288, 320, 3, 2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          max_pool_3_2(x)], 1)


class InceptionResNetV2ReID(ReIDNet):
    """torchreid's ``inceptionresnetv2`` without its classifier: images
    [B, 3, H, W] normalized RGB (H, W >= 75) -> features [B, 1536]
    float32."""

    def __init__(self, name: str = "inceptionresnetv2"):
        super().__init__()
        self.conv2d_1a = BasicConv2d(3, 32, 3, 2)
        self.conv2d_2a = BasicConv2d(32, 32, 3)
        self.conv2d_2b = BasicConv2d(32, 64, 3, 1, 1)
        self.conv2d_3b = BasicConv2d(64, 80, 1)
        self.conv2d_4a = BasicConv2d(80, 192, 3)
        self.mixed_5b = Mixed5b()
        self.repeat = nn.Sequential(*[Block35(0.17) for _ in range(10)])
        self.mixed_6a = Mixed6a()
        self.repeat_1 = nn.Sequential(*[Block17(0.10) for _ in range(20)])
        self.mixed_7a = Mixed7a()
        self.repeat_2 = nn.Sequential(*[Block8(0.20) for _ in range(9)])
        self.block8 = Block8(relu=False)
        self.conv2d_7b = BasicConv2d(2080, 1536, 1)
        self.feature_dim = 1536
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = self.conv2d_4a(self.conv2d_3b(max_pool_3_2(x)))
        x = self.mixed_5b(max_pool_3_2(x))
        x = self.mixed_7a(self.repeat_1(self.mixed_6a(self.repeat(x))))
        x = self.conv2d_7b(self.block8(self.repeat_2(x)))
        return x.mean((2, 3)).float()
