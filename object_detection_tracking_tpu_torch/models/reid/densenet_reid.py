"""DenseNet ReID nets, ``densenet121``/``169``/``201``/``161`` and
``densenet121_fc512`` (port of object_detection_tracking_tpu/models/reid/
densenet_reid.py:1-62), built as torchreid's densenet.py builds them
(torchvision's DenseNet): ``features`` holds a 7x7/2 stem (``conv0``,
``norm0``, ReLU, 3x3/2 max pool), dense blocks of layers [BN, ReLU, 1x1
conv to 4 x growth, BN, ReLU, 3x3 conv to growth] whose outputs are
concatenated onto their input, transitions [BN, ReLU, 1x1 conv halving
the channels, 2x2 average pool] between blocks, and ``norm5``; then ReLU,
GAP and, for densenet121_fc512, a 512-d fc head (Linear, BN1d, ReLU).
The JAX forward reads the block structure from the checkpoint's names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, fc_head, init_params

# (stem width, growth rate, layers per block)
CONFIGS = {
    "densenet121": (64, 32, (6, 12, 24, 16)),
    "densenet169": (64, 32, (6, 12, 32, 32)),
    "densenet201": (64, 32, (6, 12, 48, 32)),
    "densenet161": (96, 48, (6, 12, 36, 24)),
    "densenet121_fc512": (64, 32, (6, 12, 24, 16)),
}
FC_DIM = {"densenet121_fc512": 512}
BN_SIZE = 4


class DenseLayer(nn.Sequential):
    def __init__(self, c_in: int, growth: int):
        super().__init__()
        self.add_module("norm1", nn.BatchNorm2d(c_in))
        self.add_module("relu1", nn.ReLU(inplace=True))
        self.add_module("conv1", nn.Conv2d(c_in, BN_SIZE * growth, 1,
                                           bias=False))
        self.add_module("norm2", nn.BatchNorm2d(BN_SIZE * growth))
        self.add_module("relu2", nn.ReLU(inplace=True))
        self.add_module("conv2", nn.Conv2d(BN_SIZE * growth, growth, 3,
                                           padding=1, bias=False))

    def forward(self, x):
        return torch.cat([x, super().forward(x)], 1)


class Transition(nn.Sequential):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.add_module("norm", nn.BatchNorm2d(c_in))
        self.add_module("relu", nn.ReLU(inplace=True))
        self.add_module("conv", nn.Conv2d(c_in, c_out, 1, bias=False))
        self.add_module("pool", nn.AvgPool2d(2, 2))


class DenseNetReID(ReIDNet):
    """torchreid's DenseNet of ``name`` without its classifier: images
    [B, 3, H, W] normalized RGB -> features [B, D] float32."""

    def __init__(self, name: str):
        super().__init__()
        stem, growth, blocks = CONFIGS[name]
        f = nn.Sequential()
        f.add_module("conv0", nn.Conv2d(3, stem, 7, 2, 3, bias=False))
        f.add_module("norm0", nn.BatchNorm2d(stem))
        f.add_module("relu0", nn.ReLU(inplace=True))
        f.add_module("pool0", nn.MaxPool2d(3, 2, 1))
        c = stem
        for i, n in enumerate(blocks, start=1):
            block = nn.Sequential()
            for j in range(1, n + 1):
                block.add_module(f"denselayer{j}", DenseLayer(c, growth))
                c += growth
            f.add_module(f"denseblock{i}", block)
            if i != len(blocks):
                f.add_module(f"transition{i}", Transition(c, c // 2))
                c //= 2
        f.add_module("norm5", nn.BatchNorm2d(c))
        self.features = f
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = fc_head(c, FC_DIM[name]) if name in FC_DIM else None
        self.feature_dim = FC_DIM.get(name, c)
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.features(x))
        v = self.global_avgpool(x).flatten(1)
        if self.fc is not None:
            v = self.fc(v)
        return v.float()
