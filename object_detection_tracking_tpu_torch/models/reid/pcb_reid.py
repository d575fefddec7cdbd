"""PCB ReID nets, ``pcb_p6`` and ``pcb_p4`` (port of
object_detection_tracking_tpu/models/reid/pcb_reid.py:1-64), built as
torchreid's pcb.py builds them: a torchvision ResNet-50 trunk with layer4
at stride 1, ``parts_avgpool`` (AdaptiveAvgPool2d((parts, 1))), and the
training-only ``conv5`` (DimReduceLayer: 1x1 conv 2048->256, BN, ReLU),
which the eval forward does not run but a torchreid checkpoint holds. The
eval features: each part's 2048-d average L2-normalized over the channels
(``F.normalize(dim=1)``), flattened channel-major to [B, 2048 * parts].

The adaptive pool's bin i covers rows [floor(i H / parts),
ceil((i + 1) H / parts)), the bins of JAX's ``_adaptive_avg_pool_h``
(pcb_reid.py:34), also where ``parts`` does not divide H.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, init_params
from .resnet_reid import Bottleneck

PARTS = {"pcb_p6": 6, "pcb_p4": 4}
RESNET50 = (3, 4, 6, 3)


def resnet50_trunk(net: nn.Module, last_stride: int) -> int:
    """torchvision's ResNet-50 stem and layers on ``net`` (``conv1``,
    ``bn1``, ``relu``, ``maxpool``, ``layer1``..``layer4``), layer4 at
    ``last_stride``; returns the output channels."""
    net.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
    net.bn1 = nn.BatchNorm2d(64)
    net.relu = nn.ReLU(inplace=True)
    net.maxpool = nn.MaxPool2d(3, 2, 1)
    c_in = 64
    for li, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                RESNET50), start=1):
        stride = 1 if li == 1 else (last_stride if li == 4 else 2)
        blocks = []
        for b in range(n_blocks):
            blocks.append(Bottleneck(c_in, planes, stride if b == 0 else 1))
            c_in = planes * Bottleneck.expansion
        setattr(net, f"layer{li}", nn.Sequential(*blocks))
    return c_in


class DimReduceLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Conv2d(c_in, c_out, 1, bias=False),
                                    nn.BatchNorm2d(c_out),
                                    nn.ReLU(inplace=True))


class PCBReID(ReIDNet):
    """torchreid's ``pcb_p6``/``pcb_p4`` without its classifiers: images
    [B, 3, H, W] normalized RGB -> features [B, 2048 * parts] float32."""

    def __init__(self, name: str):
        super().__init__()
        self.parts = PARTS[name]
        c = resnet50_trunk(self, last_stride=1)
        self.parts_avgpool = nn.AdaptiveAvgPool2d((self.parts, 1))
        self.conv5 = DimReduceLayer(c, 256)
        self.feature_dim = c * self.parts
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        v = F.normalize(self.parts_avgpool(x.float()), p=2, dim=1)
        return v.flatten(1)
