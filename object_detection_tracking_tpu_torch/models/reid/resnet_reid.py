"""ResNet-family ReID nets (port of
object_detection_tracking_tpu/models/reid/resnet_reid.py:20-80), built as
torchreid's resnet.py builds them: torchvision blocks, last stride 2, GAP
features (resnet18/34: BasicBlock, 512-d; resnet50/101/152 and the
ResNeXts: Bottleneck, 2048-d); ``resnet50_fc512`` keeps layer4 at stride 1
and adds a 512-d fc head (Linear, BN1d, ReLU).

The JAX forward tells BasicBlock from Bottleneck by the checkpoint's
``layer1.0.conv3.weight`` (:65); here the name decides, and a checkpoint
of the other layout fails ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ReIDNet, fc_head, init_params

LAYERS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
          "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet152": (3, 8, 36, 3),
          "resnext50_32x4d": (3, 4, 6, 3), "resnext101_32x8d": (3, 4, 23, 3),
          "resnet50_fc512": (3, 4, 6, 3)}
BASIC = ("resnet18", "resnet34")
# resnet50_fc512 keeps layer4 at stride 1 (torchreid resnet.py:517-527)
LAST_STRIDE = {"resnet50_fc512": 1}
# ResNeXt: (groups, width per group) of the 3x3 convs (resnet.py:476-506)
GROUPS = {"resnext50_32x4d": (32, 4), "resnext101_32x8d": (32, 8)}
FC_DIM = {"resnet50_fc512": 512}


def _downsample(c_in: int, c_out: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(c_in, c_out, 1, stride, bias=False),
                         nn.BatchNorm2d(c_out))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_downsample(c_in, planes, stride)
                           if stride != 1 or c_in != planes else None)

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(out + identity)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck: the stride and the groups on the 3x3, or
    with ``stride_1x1`` the stride on conv1 (SENet's se_resnet). A subclass
    may set ``se_module`` (scales the branch before the residual add) or
    ``IN`` (a norm after the add, before the ReLU): the SE and IBN nets'
    blocks."""

    expansion = 4

    def __init__(self, c_in: int, planes: int, stride: int = 1,
                 groups: int = 1, base_width: int = 64,
                 stride_1x1: bool = False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        c_out = planes * self.expansion
        s1, s2 = (stride, 1) if stride_1x1 else (1, stride)
        self.conv1 = nn.Conv2d(c_in, width, 1, s1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, s2, 1, groups=groups,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, c_out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(c_out)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = (_downsample(c_in, c_out, stride)
                           if stride != 1 or c_in != c_out else None)
        self.se_module = None
        self.IN = None

    def forward(self, x):
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.se_module is not None:
            out = self.se_module(out)
        out = out + (x if self.downsample is None else self.downsample(x))
        if self.IN is not None:
            out = self.IN(out)
        return self.relu(out)


class ResNetReID(ReIDNet):
    """torchreid's ``resnet*``/``resnext*`` net of ``name`` without its
    classifier: images [B, 3, H, W] normalized RGB -> features [B, D]
    float32."""

    def __init__(self, name: str):
        super().__init__()
        block = BasicBlock if name in BASIC else Bottleneck
        groups, base_width = GROUPS.get(name, (1, 64))
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        c_in = 64
        for li, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                    LAYERS[name]), start=1):
            stride = 1 if li == 1 else (LAST_STRIDE.get(name, 2) if li == 4
                                        else 2)
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(c_in, planes, stride if b == 0 else 1,
                                    groups, base_width))
                c_in = planes * block.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = fc_head(c_in, FC_DIM[name]) if name in FC_DIM else None
        self.feature_dim = FC_DIM.get(name, c_in)
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        v = self.global_avgpool(x).flatten(1)
        if self.fc is not None:
            v = self.fc(v)
        return v.float()
