"""SENet-family ReID nets (port of
object_detection_tracking_tpu/models/reid/senet_reid.py:1-72), built as
torchreid's senet.py builds them (the Cadene SENet): ``layer0`` a 7x7/2
conv, BN, ReLU and a ceil-mode 3x3/2 max pool; bottlenecks whose squeeze-
and-excitation gate (``se_module``: GAP, 1x1 ``fc1``, ReLU, 1x1 ``fc2``,
sigmoid; reduction 16) scales the branch before the residual add; last
stride 2 and GAP features (2048-d), or ``se_resnet50_fc512``: last stride
1 and a 512-d fc head (Linear, BN1d, ReLU).

Where the stride sits differs by variant (the Caffe quirk, JAX :1-11):
se_resnet puts it on the 1x1 ``conv1``, se_resnext (32 groups, base width
4) on the grouped 3x3 ``conv2``. The downsample is a 1x1 conv with the
block's stride and a BN.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ReIDNet, fc_head, init_params
from .resnet_reid import Bottleneck

LAYERS = {
    "se_resnet50": (3, 4, 6, 3),
    "se_resnet50_fc512": (3, 4, 6, 3),
    "se_resnet101": (3, 4, 23, 3),
    "se_resnext50_32x4d": (3, 4, 6, 3),
    "se_resnext101_32x4d": (3, 4, 23, 3),
}
LAST_STRIDE = {"se_resnet50_fc512": 1}
FC_DIM = {"se_resnet50_fc512": 512}
REDUCTION = 16


class SEModule(nn.Module):
    def __init__(self, channels: int, reduction: int):
        super().__init__()
        self.avg_pool = nn.AdaptiveAvgPool2d(1)
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.relu = nn.ReLU(inplace=True)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)
        self.sigmoid = nn.Sigmoid()

    def forward(self, x):
        s = self.relu(self.fc1(self.avg_pool(x)))
        return x * self.sigmoid(self.fc2(s))


class SEBottleneck(Bottleneck):
    """SEResNetBottleneck (``resnext=False``: the stride on conv1) or
    SEResNeXtBottleneck (``resnext=True``: 32 groups of width
    floor(planes * 4 / 64), the stride on conv2)."""

    def __init__(self, c_in: int, planes: int, stride: int, resnext: bool):
        groups, base_width = (32, 4) if resnext else (1, 64)
        super().__init__(c_in, planes, stride, groups, base_width,
                         stride_1x1=not resnext)
        self.se_module = SEModule(planes * self.expansion, REDUCTION)


class SENetReID(ReIDNet):
    """torchreid's ``se_resnet*``/``se_resnext*`` net of ``name`` without
    its classifier: images [B, 3, H, W] normalized RGB -> features [B, D]
    float32."""

    def __init__(self, name: str):
        super().__init__()
        resnext = "resnext" in name
        self.layer0 = nn.Sequential()
        self.layer0.add_module("conv1", nn.Conv2d(3, 64, 7, 2, 3,
                                                  bias=False))
        self.layer0.add_module("bn1", nn.BatchNorm2d(64))
        self.layer0.add_module("relu1", nn.ReLU(inplace=True))
        self.layer0.add_module("pool", nn.MaxPool2d(3, 2, ceil_mode=True))
        c_in = 64
        for li, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                    LAYERS[name]), start=1):
            stride = 1 if li == 1 else (LAST_STRIDE.get(name, 2) if li == 4
                                        else 2)
            blocks = []
            for b in range(n_blocks):
                blocks.append(SEBottleneck(c_in, planes,
                                           stride if b == 0 else 1, resnext))
                c_in = planes * SEBottleneck.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = fc_head(c_in, FC_DIM[name]) if name in FC_DIM else None
        self.feature_dim = FC_DIM.get(name, c_in)
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer0(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        v = self.global_avgpool(x).flatten(1)
        if self.fc is not None:
            v = self.fc(v)
        return v.float()
