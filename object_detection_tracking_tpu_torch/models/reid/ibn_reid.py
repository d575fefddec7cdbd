"""IBN-Net ReID nets, ``resnet50_ibn_a`` and ``resnet50_ibn_b`` (port of
object_detection_tracking_tpu/models/reid/ibn_reid.py:1-82), built as
torchreid's resnet_ibn_a.py and resnet_ibn_b.py build them: ResNet-50's
Bottleneck layout (the stride on the 3x3), last stride 2, GAP features
(2048-d), with instance norms (affine, no running statistics) where:

- ibn_a: every block of layers 1-3 replaces bn1 by IBN: the first half of
  its channels (``bn1.IN``) instance-normed, the rest batch-normed
  (``bn1.BN``), concatenated;
- ibn_b: the stem's norm ``bn1`` is an instance norm, and the last block of
  layers 1 and 2 applies one (``IN``) after the residual add, before the
  ReLU.

The JAX forward finds where the instance norms sit from the checkpoint's
key names; here the layout is torchreid's, fixed by the name, and a
checkpoint of another layout fails ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ReIDNet, init_params
from .resnet_reid import Bottleneck

LAYERS = (3, 4, 6, 3)


class IBN(nn.Module):
    """IN on channels [:half], BN on the rest (resnet_ibn_a.py:63-78)."""

    def __init__(self, planes: int):
        super().__init__()
        self.half = planes // 2
        self.IN = nn.InstanceNorm2d(self.half, affine=True)
        self.BN = nn.BatchNorm2d(planes - self.half)

    def forward(self, x):
        a, b = torch.split(x, [self.half, x.shape[1] - self.half], 1)
        return torch.cat([self.IN(a.contiguous()), self.BN(b.contiguous())],
                         1)


class IBNBottleneck(Bottleneck):
    """ResNet Bottleneck with ibn_a's IBN bn1 (``ibn``) or ibn_b's
    instance norm after the residual add (``post_in``)."""

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 ibn: bool = False, post_in: bool = False):
        super().__init__(c_in, planes, stride)
        if ibn:
            self.bn1 = IBN(planes)
        if post_in:
            self.IN = nn.InstanceNorm2d(planes * self.expansion, affine=True)


class IBNReID(ReIDNet):
    """torchreid's ``resnet50_ibn_a`` / ``resnet50_ibn_b`` without its
    classifier: images [B, 3, H, W] normalized RGB -> features [B, 2048]
    float32."""

    def __init__(self, name: str):
        super().__init__()
        if name not in ("resnet50_ibn_a", "resnet50_ibn_b"):
            raise ValueError(f"unknown IBN net {name!r}")
        ibn_a = name == "resnet50_ibn_a"
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = (nn.BatchNorm2d(64) if ibn_a
                    else nn.InstanceNorm2d(64, affine=True))
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        c_in = 64
        for li, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                    LAYERS), start=1):
            blocks = []
            for b in range(n_blocks):
                blocks.append(IBNBottleneck(
                    c_in, planes, 2 if (li > 1 and b == 0) else 1,
                    ibn=ibn_a and planes != 512,
                    post_in=not ibn_a and li <= 2 and b == n_blocks - 1))
                c_in = planes * IBNBottleneck.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.feature_dim = c_in
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.global_avgpool(x).flatten(1).float()
