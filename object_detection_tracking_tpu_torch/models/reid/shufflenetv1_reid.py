"""ShuffleNet (v1, 3 groups) ReID net, ``shufflenet`` (port of
object_detection_tracking_tpu/models/reid/shufflenetv1_reid.py:1-65),
built as torchreid's shufflenet.py builds it: ``conv1`` a 3x3/2 conv, BN,
ReLU and a 3x3/2 max pool; stages ``stage2``..``stage4`` of 4, 8 and 4
bottlenecks (grouped 1x1 ``conv1``, BN, ReLU, channel shuffle, depthwise
3x3 ``conv2`` and BN, grouped 1x1 ``conv3`` and BN). The first unit of
each stage has stride 2: its branch gives ``out - in`` channels and is
concatenated after a 3x3/2 average pool of its input (zero padding
counted in the divisor); the others add the input. Stage 2's first
``conv1`` is not grouped (its 24 input channels). GAP features, 960-d.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, init_params
from .shufflenet_reid import channel_shuffle

GROUPS = 3
CHANNELS = (240, 480, 960)      # torchreid's cfg[3]
REPEATS = (4, 8, 4)


class ShuffleBottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int,
                 group_conv1x1: bool = True):
        super().__init__()
        self.stride = stride
        mid = c_out // 4
        if stride == 2:
            c_out -= c_in
        self.conv1 = nn.Conv2d(c_in, mid, 1, bias=False,
                               groups=GROUPS if group_conv1x1 else 1)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, groups=mid,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, c_out, 1, groups=GROUPS, bias=False)
        self.bn3 = nn.BatchNorm2d(c_out)

    def forward(self, x):
        out = channel_shuffle(F.relu(self.bn1(self.conv1(x))), GROUPS)
        out = self.bn3(self.conv3(self.bn2(self.conv2(out))))
        if self.stride == 2:
            return F.relu(torch.cat([F.avg_pool2d(x, 3, 2, 1), out], 1))
        return F.relu(x + out)


class ShuffleNetV1ReID(ReIDNet):
    """torchreid's ``shufflenet`` without its classifier: images
    [B, 3, H, W] normalized RGB -> features [B, 960] float32."""

    def __init__(self, name: str = "shufflenet"):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(3, 24, 3, 2, 1, bias=False),
                                   nn.BatchNorm2d(24), nn.ReLU(),
                                   nn.MaxPool2d(3, 2, 1))
        c_in = 24
        for i, (n, c_out) in enumerate(zip(REPEATS, CHANNELS), start=2):
            units = [ShuffleBottleneck(c_in, c_out, 2,
                                       group_conv1x1=i > 2)]
            units += [ShuffleBottleneck(c_out, c_out, 1)
                      for _ in range(n - 1)]
            setattr(self, f"stage{i}", nn.Sequential(*units))
            c_in = c_out
        self.feature_dim = c_in
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stage4(self.stage3(self.stage2(self.conv1(x))))
        return x.mean(dim=(2, 3)).float()
