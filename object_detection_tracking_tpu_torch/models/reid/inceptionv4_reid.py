"""Inception-v4 ReID net, ``inceptionv4`` (port of
object_detection_tracking_tpu/models/reid/inceptionv4_reid.py:1-119),
built as torchreid's inceptionv4.py (the Cadene pretrainedmodels graph)
builds it: ``features``, a Sequential of the unpadded stem convs (slots
0-2), Mixed_3a/4a/5a (3-5), 4 Inception-A (6-9), Reduction-A (10), 7
Inception-B (11-17), Reduction-B (18) and 3 Inception-C (19-21); GAP
features, 1536-d. Every BasicConv2d is a conv without bias, BN with eps
1e-3 and ReLU; the branch average pools leave the padding out of the
divisor (``count_include_pad=False``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, init_params

BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    def __init__(self, c_in: int, c_out: int, k, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def seq(*specs) -> nn.Sequential:
    """A Sequential of BasicConv2d (c_in, c_out, k, stride, padding)."""
    return nn.Sequential(*[BasicConv2d(*s) for s in specs])


def pool_branch(c_in: int, c_out: int) -> nn.Sequential:
    """3x3/1 average pool (padding out of the divisor), then a 1x1."""
    return nn.Sequential(nn.AvgPool2d(3, 1, 1, count_include_pad=False),
                         BasicConv2d(c_in, c_out, 1))


def max_pool_3_2(x):
    return F.max_pool2d(x, 3, 2)


class Mixed3a(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = BasicConv2d(64, 96, 3, 2)

    def forward(self, x):
        return torch.cat([max_pool_3_2(x), self.conv(x)], 1)


class Mixed4a(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = seq((160, 64, 1), (64, 96, 3))
        self.branch1 = seq((160, 64, 1), (64, 64, (1, 7), 1, (0, 3)),
                           (64, 64, (7, 1), 1, (3, 0)), (64, 96, 3))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x)], 1)


class Mixed5a(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = BasicConv2d(192, 192, 3, 2)

    def forward(self, x):
        return torch.cat([self.conv(x), max_pool_3_2(x)], 1)


class InceptionA(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(384, 96, 1)
        self.branch1 = seq((384, 64, 1), (64, 96, 3, 1, 1))
        self.branch2 = seq((384, 64, 1), (64, 96, 3, 1, 1),
                           (96, 96, 3, 1, 1))
        self.branch3 = pool_branch(384, 96)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class ReductionA(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(384, 384, 3, 2)
        self.branch1 = seq((384, 192, 1), (192, 224, 3, 1, 1),
                           (224, 256, 3, 2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), max_pool_3_2(x)],
                         1)


class InceptionB(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(1024, 384, 1)
        self.branch1 = seq((1024, 192, 1), (192, 224, (1, 7), 1, (0, 3)),
                           (224, 256, (7, 1), 1, (3, 0)))
        self.branch2 = seq((1024, 192, 1), (192, 192, (7, 1), 1, (3, 0)),
                           (192, 224, (1, 7), 1, (0, 3)),
                           (224, 224, (7, 1), 1, (3, 0)),
                           (224, 256, (1, 7), 1, (0, 3)))
        self.branch3 = pool_branch(1024, 128)

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


class ReductionB(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = seq((1024, 192, 1), (192, 192, 3, 2))
        self.branch1 = seq((1024, 256, 1), (256, 256, (1, 7), 1, (0, 3)),
                           (256, 320, (7, 1), 1, (3, 0)), (320, 320, 3, 2))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), max_pool_3_2(x)],
                         1)


class InceptionC(nn.Module):
    def __init__(self):
        super().__init__()
        self.branch0 = BasicConv2d(1536, 256, 1)
        self.branch1_0 = BasicConv2d(1536, 384, 1)
        self.branch1_1a = BasicConv2d(384, 256, (1, 3), 1, (0, 1))
        self.branch1_1b = BasicConv2d(384, 256, (3, 1), 1, (1, 0))
        self.branch2_0 = BasicConv2d(1536, 384, 1)
        self.branch2_1 = BasicConv2d(384, 448, (3, 1), 1, (1, 0))
        self.branch2_2 = BasicConv2d(448, 512, (1, 3), 1, (0, 1))
        self.branch2_3a = BasicConv2d(512, 256, (1, 3), 1, (0, 1))
        self.branch2_3b = BasicConv2d(512, 256, (3, 1), 1, (1, 0))
        self.branch3 = pool_branch(1536, 256)

    def forward(self, x):
        b1 = self.branch1_0(x)
        b2 = self.branch2_2(self.branch2_1(self.branch2_0(x)))
        return torch.cat([self.branch0(x), self.branch1_1a(b1),
                          self.branch1_1b(b1), self.branch2_3a(b2),
                          self.branch2_3b(b2), self.branch3(x)], 1)


class InceptionV4ReID(ReIDNet):
    """torchreid's ``inceptionv4`` without its classifier: images
    [B, 3, H, W] normalized RGB (H, W >= 75) -> features [B, 1536]
    float32."""

    def __init__(self, name: str = "inceptionv4"):
        super().__init__()
        self.features = nn.Sequential(
            BasicConv2d(3, 32, 3, 2), BasicConv2d(32, 32, 3),
            BasicConv2d(32, 64, 3, 1, 1), Mixed3a(), Mixed4a(), Mixed5a(),
            *[InceptionA() for _ in range(4)], ReductionA(),
            *[InceptionB() for _ in range(7)], ReductionB(),
            *[InceptionC() for _ in range(3)])
        self.feature_dim = 1536
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x).mean((2, 3)).float()
