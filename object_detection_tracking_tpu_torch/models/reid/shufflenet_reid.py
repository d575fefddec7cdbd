"""ShuffleNetV2 ReID nets, ``shufflenet_v2_x0_5``/``x1_0``/``x1_5``/``x2_0``
(port of object_detection_tracking_tpu/models/reid/shufflenet_reid.py:
1-68), built as torchreid's shufflenetv2.py builds them (torchvision's
ShuffleNetV2): ``conv1`` a 3x3/2 conv, BN, ReLU; a 3x3/2 max pool; stages
``stage2``..``stage4`` of 4, 8 and 4 inverted-residual units (the first of
each, stride 2, runs ``branch1`` and ``branch2`` on the whole input; the
others split the channels in halves and transform the second with
``branch2``), each unit's output shuffled across its two halves; ``conv5``
a 1x1 conv, BN, ReLU; GAP features.

The channel shuffle: [x1 | x2] of C channels becomes x1[0], x2[0], x1[1],
x2[1], ... (view as [B, 2, C/2, H, W], swap the two axes), JAX's order on
NHWC.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ReIDNet, init_params

REPEATS = (4, 8, 4)
CHANNELS = {"shufflenet_v2_x0_5": (24, 48, 96, 192, 1024),
            "shufflenet_v2_x1_0": (24, 116, 232, 464, 1024),
            "shufflenet_v2_x1_5": (24, 176, 352, 704, 1024),
            "shufflenet_v2_x2_0": (24, 244, 488, 976, 2048)}


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    b, c, h, w = x.shape
    x = x.view(b, groups, c // groups, h, w).transpose(1, 2).contiguous()
    return x.view(b, c, h, w)


def _depthwise(c: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(c, c, 3, stride, 1, bias=False, groups=c)


class InvertedResidual(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.stride = stride
        f = c_out // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                _depthwise(c_in, stride), nn.BatchNorm2d(c_in),
                nn.Conv2d(c_in, f, 1, bias=False), nn.BatchNorm2d(f),
                nn.ReLU(inplace=True))
        self.branch2 = nn.Sequential(
            nn.Conv2d(c_in if stride > 1 else f, f, 1, bias=False),
            nn.BatchNorm2d(f), nn.ReLU(inplace=True),
            _depthwise(f, stride), nn.BatchNorm2d(f),
            nn.Conv2d(f, f, 1, bias=False), nn.BatchNorm2d(f),
            nn.ReLU(inplace=True))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return channel_shuffle(out)


class ShuffleNetV2ReID(ReIDNet):
    """torchreid's ShuffleNetV2 of ``name`` without its classifier: images
    [B, 3, H, W] normalized RGB -> features [B, D] float32."""

    def __init__(self, name: str):
        super().__init__()
        chans = CHANNELS[name]
        self.conv1 = nn.Sequential(nn.Conv2d(3, chans[0], 3, 2, 1,
                                             bias=False),
                                   nn.BatchNorm2d(chans[0]),
                                   nn.ReLU(inplace=True))
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        c_in = chans[0]
        for i, (n, c_out) in enumerate(zip(REPEATS, chans[1:4]), start=2):
            units = [InvertedResidual(c_in, c_out, 2)]
            units += [InvertedResidual(c_out, c_out, 1) for _ in range(n - 1)]
            setattr(self, f"stage{i}", nn.Sequential(*units))
            c_in = c_out
        self.conv5 = nn.Sequential(nn.Conv2d(c_in, chans[4], 1, bias=False),
                                   nn.BatchNorm2d(chans[4]),
                                   nn.ReLU(inplace=True))
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.feature_dim = chans[4]
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.conv1(x))
        x = self.conv5(self.stage4(self.stage3(self.stage2(x))))
        return self.global_avgpool(x).flatten(1).float()
