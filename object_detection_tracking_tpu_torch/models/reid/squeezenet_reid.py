"""SqueezeNet ReID nets, ``squeezenet1_0``, ``squeezenet1_0_fc512`` and
``squeezenet1_1`` (port of object_detection_tracking_tpu/models/reid/
squeezenet_reid.py:1-48), built as torchreid's squeezenet.py builds them:
``features`` a Sequential of an unpadded stem conv with bias (v1.0: 96
channels 7x7/2; v1.1: 64 channels 3x3/2), ReLU, ceil-mode 3x3/2 max pools
and Fire modules (1x1 ``squeeze``, ReLU, then ReLU'd 1x1 ``expand1x1`` and
3x3 ``expand3x3`` concatenated) at torchreid's slots; GAP features
(512-d), and for squeezenet1_0_fc512 a 512-d fc head (Linear, BN1d,
ReLU).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ReIDNet, fc_head, init_params

# the Sequential's slots after the stem (0 conv, 1 ReLU, 2 pool): "P" a
# ceil-mode max pool, else a Fire module (c_in, squeeze, expand1x1,
# expand3x3) (squeezenet.py:79-109)
V10 = ((96, 16, 64, 64), (128, 16, 64, 64), (128, 32, 128, 128), "P",
       (256, 32, 128, 128), (256, 48, 192, 192), (384, 48, 192, 192),
       (384, 64, 256, 256), "P", (512, 64, 256, 256))
V11 = ((64, 16, 64, 64), (128, 16, 64, 64), "P", (128, 32, 128, 128),
       (256, 32, 128, 128), "P", (256, 48, 192, 192), (384, 48, 192, 192),
       (384, 64, 256, 256), (512, 64, 256, 256))
VERSION = {"squeezenet1_0": "1.0", "squeezenet1_0_fc512": "1.0",
           "squeezenet1_1": "1.1"}
FC_DIM = {"squeezenet1_0_fc512": 512}


class Fire(nn.Module):
    def __init__(self, c_in: int, squeeze: int, e1: int, e3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(c_in, squeeze, 1)
        self.squeeze_activation = nn.ReLU(inplace=True)
        self.expand1x1 = nn.Conv2d(squeeze, e1, 1)
        self.expand1x1_activation = nn.ReLU(inplace=True)
        self.expand3x3 = nn.Conv2d(squeeze, e3, 3, padding=1)
        self.expand3x3_activation = nn.ReLU(inplace=True)

    def forward(self, x):
        s = self.squeeze_activation(self.squeeze(x))
        return torch.cat([self.expand1x1_activation(self.expand1x1(s)),
                          self.expand3x3_activation(self.expand3x3(s))], 1)


class SqueezeNetReID(ReIDNet):
    """torchreid's SqueezeNet of ``name`` without its classifier: images
    [B, 3, H, W] normalized RGB -> features [B, D] float32."""

    def __init__(self, name: str):
        super().__init__()
        v10 = VERSION[name] == "1.0"
        layers = [nn.Conv2d(3, 96, 7, 2) if v10 else nn.Conv2d(3, 64, 3, 2),
                  nn.ReLU(inplace=True), nn.MaxPool2d(3, 2, ceil_mode=True)]
        for slot in (V10 if v10 else V11):
            layers.append(nn.MaxPool2d(3, 2, ceil_mode=True) if slot == "P"
                          else Fire(*slot))
        self.features = nn.Sequential(*layers)
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = fc_head(512, FC_DIM[name]) if name in FC_DIM else None
        self.feature_dim = FC_DIM.get(name, 512)
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.global_avgpool(self.features(x)).flatten(1)
        if self.fc is not None:
            v = self.fc(v)
        return v.float()
