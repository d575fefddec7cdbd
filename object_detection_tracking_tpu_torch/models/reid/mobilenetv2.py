"""MobileNetV2 ReID nets, ``mobilenetv2_x1_0`` and ``mobilenetv2_x1_4``
(port of object_detection_tracking_tpu/models/reid/mobilenetv2.py:1-53),
built as torchreid's mobilenetv2.py builds them: ``conv1`` a 3x3/2
ConvBlock (conv without bias, BN, ReLU6), seven stacks ``conv2``..``conv8``
of inverted-residual bottlenecks, ``conv9`` a 1x1 ConvBlock, GAP features
(1280-d, or 1280 x width above 1).

torchreid's bottleneck always has its 1x1 expansion ConvBlock (``conv1``),
also at expansion 1, where torchvision's MobileNetV2 has none; then the
depthwise 3x3 ConvBlock (``dwconv2``) with the stride, and the linear
1x1 projection (``conv3``: conv, BN). The residual is added where the
stride is 1 and the widths agree. Widths are int(c x width) (JAX reads
them from the checkpoint).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, init_params

WIDTH = {"mobilenetv2_x1_0": 1.0, "mobilenetv2_x1_4": 1.4}
# (expansion t, output channels c, repeats n, stride s) of conv2..conv8
# (torchreid mobilenetv2.py:95-118)
STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class ConvBlock(nn.Module):
    """conv (no bias), BN, ReLU6."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int = 1,
                 p: int = 0, g: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride=s, padding=p,
                              bias=False, groups=g)
        self.bn = nn.BatchNorm2d(c_out)

    def forward(self, x):
        return F.relu6(self.bn(self.conv(x)))


class MobileBottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, expansion: int, stride: int):
        super().__init__()
        mid = c_in * expansion
        self.use_residual = stride == 1 and c_in == c_out
        self.conv1 = ConvBlock(c_in, mid, 1)
        self.dwconv2 = ConvBlock(mid, mid, 3, stride, 1, g=mid)
        self.conv3 = nn.Sequential(nn.Conv2d(mid, c_out, 1, bias=False),
                                   nn.BatchNorm2d(c_out))

    def forward(self, x):
        m = self.conv3(self.dwconv2(self.conv1(x)))
        return x + m if self.use_residual else m


class MobileNetV2ReID(ReIDNet):
    """torchreid's MobileNetV2 of ``name`` without its classifier: images
    [B, 3, H, W] normalized RGB -> features [B, D] float32."""

    def __init__(self, name: str):
        super().__init__()
        wm = WIDTH[name]
        c_in = int(32 * wm)
        self.conv1 = ConvBlock(3, c_in, 3, s=2, p=1)
        for i, (t, c, n, s) in enumerate(STAGES, start=2):
            c_out = int(c * wm)
            blocks = []
            for b in range(n):
                blocks.append(MobileBottleneck(c_in, c_out, t,
                                               s if b == 0 else 1))
                c_in = c_out
            setattr(self, f"conv{i}", nn.Sequential(*blocks))
        self.feature_dim = int(1280 * wm) if wm > 1 else 1280
        self.conv9 = ConvBlock(c_in, self.feature_dim, 1)
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        for i in range(2, 9):
            x = getattr(self, f"conv{i}")(x)
        x = self.conv9(x)
        return self.global_avgpool(x).flatten(1).float()
