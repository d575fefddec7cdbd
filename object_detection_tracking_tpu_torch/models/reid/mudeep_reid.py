"""MuDeep ReID net, ``mudeep`` (port of
object_detection_tracking_tpu/models/reid/mudeep_reid.py:1-80), built as
torchreid's mudeep.py builds it, for its fixed 256x128 input:
``block1`` two 3x3 ConvBlocks (conv with bias, BN, ReLU) and a 3x3/2 max
pool; ``block2`` MultiScaleA (four streams, 96 channels); ``block3`` the
Reduction (a 3x3/2 max pool and two strided conv streams, 256 channels);
``block4`` MultiScaleB (four streams of 1x3/3x1 convs, 256 channels
each); ``block5`` the Fusion (per-channel saliency weights ``a1``..``a4``
[1, 256, 1, 1] over the four streams, summed, then a 4x4/4 average pool
to [256, 16, 8]); ``fc`` (Linear 32768->4096, BN1d, ReLU) over that map
flattened channel-major: [B, 4096].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, fc_head, init_params


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, k, s: int = 1, p=0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, p)
        self.bn = nn.BatchNorm2d(c_out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ConvLayers(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBlock(3, 48, 3, p=1)
        self.conv2 = ConvBlock(48, 96, 3, p=1)
        self.maxpool = nn.MaxPool2d(3, 2, 1)

    def forward(self, x):
        return self.maxpool(self.conv2(self.conv1(x)))


class MultiScaleA(nn.Module):
    def __init__(self):
        super().__init__()
        self.stream1 = nn.Sequential(ConvBlock(96, 96, 1),
                                     ConvBlock(96, 24, 3, p=1))
        self.stream2 = nn.Sequential(nn.AvgPool2d(3, 1, 1),
                                     ConvBlock(96, 24, 1))
        self.stream3 = ConvBlock(96, 24, 1)
        self.stream4 = nn.Sequential(ConvBlock(96, 16, 1),
                                     ConvBlock(16, 24, 3, p=1),
                                     ConvBlock(24, 24, 3, p=1))

    def forward(self, x):
        return torch.cat([self.stream1(x), self.stream2(x), self.stream3(x),
                          self.stream4(x)], 1)


class Reduction(nn.Module):
    def __init__(self):
        super().__init__()
        self.stream1 = nn.MaxPool2d(3, 2, 1)
        self.stream2 = ConvBlock(96, 96, 3, s=2, p=1)
        self.stream3 = nn.Sequential(ConvBlock(96, 48, 1),
                                     ConvBlock(48, 56, 3, p=1),
                                     ConvBlock(56, 64, 3, s=2, p=1))

    def forward(self, x):
        return torch.cat([self.stream1(x), self.stream2(x), self.stream3(x)],
                         1)


def _h(c_in, c_out):
    return ConvBlock(c_in, c_out, (1, 3), p=(0, 1))


def _v(c_in, c_out):
    return ConvBlock(c_in, c_out, (3, 1), p=(1, 0))


class MultiScaleB(nn.Module):
    def __init__(self):
        super().__init__()
        self.stream1 = nn.Sequential(nn.AvgPool2d(3, 1, 1),
                                     ConvBlock(256, 256, 1))
        self.stream2 = nn.Sequential(ConvBlock(256, 64, 1), _h(64, 128),
                                     _v(128, 256))
        self.stream3 = ConvBlock(256, 256, 1)
        self.stream4 = nn.Sequential(ConvBlock(256, 64, 1), _h(64, 64),
                                     _v(64, 128), _h(128, 128),
                                     _v(128, 256))

    def forward(self, x):
        return (self.stream1(x), self.stream2(x), self.stream3(x),
                self.stream4(x))


class Fusion(nn.Module):
    def __init__(self):
        super().__init__()
        for i in (1, 2, 3, 4):
            setattr(self, f"a{i}", nn.Parameter(torch.rand(1, 256, 1, 1)))
        self.avgpool = nn.AvgPool2d(4, 4, 0)

    def forward(self, x1, x2, x3, x4):
        return self.avgpool(self.a1 * x1 + self.a2 * x2 + self.a3 * x3
                            + self.a4 * x4)


class MuDeepReID(ReIDNet):
    """torchreid's ``mudeep`` without its classifier: images [B, 3, 256,
    128] normalized RGB -> features [B, 4096] float32."""

    def __init__(self, name: str = "mudeep"):
        super().__init__()
        self.block1 = ConvLayers()
        self.block2 = MultiScaleA()
        self.block3 = Reduction()
        self.block4 = MultiScaleB()
        self.block5 = Fusion()
        self.fc = fc_head(256 * 16 * 8, 4096)
        self.feature_dim = 4096
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[2:]) != (256, 128):
            raise ValueError("mudeep requires 256x128 input crops "
                             f"(got {tuple(x.shape[2:])})")
        x = self.block3(self.block2(self.block1(x)))
        x = self.block5(*self.block4(x))
        return self.fc(x.flatten(1)).float()
