"""ResNet-50 with mid-level fusion, ``resnet50mid`` (port of
object_detection_tracking_tpu/models/reid/resnetmid_reid.py:1-39), built
as torchreid's resnetmid.py builds it: a torchvision ResNet-50 trunk
(layer4 at stride 2) whose three layer4 block outputs are pooled apart;
the first two pooled vectors, concatenated, go through ``fc_fusion``
(Linear 4096->1024, BN1d, ReLU), and the third is appended: [B, 3072].
"""

from __future__ import annotations

import torch
from torch import nn

from .common import ReIDNet, fc_head, init_params
from .pcb_reid import resnet50_trunk


class ResNetMidReID(ReIDNet):
    """torchreid's ``resnet50mid`` without its classifier: images
    [B, 3, H, W] normalized RGB -> features [B, 3072] float32."""

    def __init__(self, name: str = "resnet50mid"):
        super().__init__()
        c = resnet50_trunk(self, last_stride=2)
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc_fusion = fc_head(2 * c, 1024)
        self.feature_dim = c + 1024
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer3(self.layer2(self.layer1(x)))
        x4a = self.layer4[0](x)
        x4b = self.layer4[1](x4a)
        x4c = self.layer4[2](x4b)
        v4ab = self.fc_fusion(torch.cat([self.global_avgpool(x4a).flatten(1),
                                         self.global_avgpool(x4b).flatten(1)],
                                        1))
        return torch.cat([v4ab, self.global_avgpool(x4c).flatten(1)],
                         1).float()
