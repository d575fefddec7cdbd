"""OSNet ReID nets (Zhou et al., ICCV 2019; port of
object_detection_tracking_tpu/models/reid/osnet.py:18-152), built as
torchreid's osnet.py and osnet_ain.py build them.

OSNet: a 7x7/2 ConvLayer stem and a 3x3/2 max pool, three stages of two
OSBlocks (Conv1x1 to a quarter of the width, four LightConv3x3 streams of
depth 1-4 that share one ChannelGate, Conv1x1Linear back, the residual),
a Conv1x1 + 2x2 avgpool transition at index ``.2`` of conv2 and conv3,
Conv1x1 ``conv5``, GAP and the 512-d fc head (Linear, BN1d, ReLU), which
runs in float32 as the JAX ``_fc_head`` (:74-80) does.

The IN variants differ only in where instance normalization sits, and the
JAX forwards read that from the checkpoint's key names (an IN stem where
``conv1.bn.running_mean`` is missing, IN after a block's residual add where
``.IN.weight`` is present, :20, :69-70). The nets here follow torchreid's
constructors of each name instead:
  * ``osnet_ibn_x1_0``: ``OSNet(..., IN=True)`` puts IN in the stem and
    passes ``IN=True`` to the first stage only (``_make_layer`` of conv2),
    so both conv2 blocks normalize after the residual add; conv3 and conv4
    have none (torchreid osnet.py, ``OSNet.__init__``).
  * ``osnet_ain_x1_0``: an IN stem (``conv1_IN=True``), and the blocks of
    ``AIN_BLOCKS``: OSBlockINin (conv3 without BN, then IN, inside the
    residual) or OSBlock; the streams are ``conv2.{t}.layers.{i}`` and the
    transitions ``pool2``/``pool3`` (osnet_ain.py:524-537).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, fc_head, init_params

# stem, conv2, conv3, conv4 widths (torchreid osnet.py ``osnet_x*``)
CHANNELS = {"osnet_x1_0": (64, 256, 384, 512),
            "osnet_x0_75": (48, 192, 288, 384),
            "osnet_x0_5": (32, 128, 192, 256),
            "osnet_x0_25": (16, 64, 96, 128),
            "osnet_ibn_x1_0": (64, 256, 384, 512)}
FEATURE_DIM = 512
# OSBlockINin (True) or OSBlock (False) per stage of osnet_ain_x1_0
AIN_BLOCKS = {"conv2": (True, True), "conv3": (False, True),
              "conv4": (True, False)}


class ConvLayer(nn.Module):
    """Conv, then BN (or affine IN), then ReLU."""

    def __init__(self, c_in, c_out, k, stride=1, padding=0, IN=False):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, stride, padding, bias=False)
        self.bn = (nn.InstanceNorm2d(c_out, affine=True) if IN
                   else nn.BatchNorm2d(c_out))
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class Conv1x1(ConvLayer):
    def __init__(self, c_in, c_out):
        super().__init__(c_in, c_out, 1)


class Conv1x1Linear(nn.Module):
    """1x1 conv and BN (none when ``bn`` is False), no activation."""

    def __init__(self, c_in, c_out, bn=True):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, 1, bias=False)
        self.bn = nn.BatchNorm2d(c_out) if bn else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.bn is None else self.bn(x)


class LightConv3x3(nn.Module):
    """1x1 conv, depthwise 3x3, BN, ReLU."""

    def __init__(self, c_in, c_out):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 1, bias=False)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, 1, 1, bias=False,
                               groups=c_out)
        self.bn = nn.BatchNorm2d(c_out)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        return self.relu(self.bn(self.conv2(self.conv1(x))))


class ChannelGate(nn.Module):
    """GAP, 1x1 fc1 (width/16), ReLU, 1x1 fc2, sigmoid; x times the gate."""

    def __init__(self, c, reduction=16):
        super().__init__()
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc1 = nn.Conv2d(c, c // reduction, 1)
        self.relu = nn.ReLU(inplace=True)
        self.fc2 = nn.Conv2d(c // reduction, c, 1)

    def forward(self, x):
        g = self.fc2(self.relu(self.fc1(self.global_avgpool(x))))
        return x * torch.sigmoid(g)


class OSBlock(nn.Module):
    """Omni-scale block; ``IN`` normalizes after the residual add."""

    def __init__(self, c_in, c_out, IN=False, reduction=4):
        super().__init__()
        mid = c_out // reduction
        self.conv1 = Conv1x1(c_in, mid)
        self.conv2a = LightConv3x3(mid, mid)
        self.conv2b = nn.Sequential(*[LightConv3x3(mid, mid)
                                      for _ in range(2)])
        self.conv2c = nn.Sequential(*[LightConv3x3(mid, mid)
                                      for _ in range(3)])
        self.conv2d = nn.Sequential(*[LightConv3x3(mid, mid)
                                      for _ in range(4)])
        self.gate = ChannelGate(mid)
        self.conv3 = Conv1x1Linear(mid, c_out)
        self.downsample = (Conv1x1Linear(c_in, c_out) if c_in != c_out
                           else None)
        self.IN = nn.InstanceNorm2d(c_out, affine=True) if IN else None

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = sum(self.gate(s(x1)) for s in (self.conv2a, self.conv2b,
                                             self.conv2c, self.conv2d))
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv3(x2) + identity
        if self.IN is not None:
            out = self.IN(out)
        return F.relu(out)


class OSNet(ReIDNet):
    """torchreid's ``osnet_x1_0``/``x0_75``/``x0_5``/``x0_25``/
    ``osnet_ibn_x1_0`` without its classifier: images [B, 3, H, W]
    normalized RGB -> features [B, 512] float32."""

    f32_modules = ("fc",)
    feature_dim = FEATURE_DIM

    def __init__(self, name: str):
        super().__init__()
        c = CHANNELS[name]
        ibn = name == "osnet_ibn_x1_0"
        self.conv1 = ConvLayer(3, c[0], 7, 2, 3, IN=ibn)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        for i, stage in enumerate(("conv2", "conv3", "conv4")):
            blocks = [OSBlock(c[i], c[i + 1], IN=ibn and i == 0),
                      OSBlock(c[i + 1], c[i + 1], IN=ibn and i == 0)]
            if stage != "conv4":
                blocks.append(nn.Sequential(Conv1x1(c[i + 1], c[i + 1]),
                                            nn.AvgPool2d(2, 2)))
            setattr(self, stage, nn.Sequential(*blocks))
        self.conv5 = Conv1x1(c[3], c[3])
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = fc_head(c[3], FEATURE_DIM)
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.conv1(x))
        x = self.conv5(self.conv4(self.conv3(self.conv2(x))))
        return self.fc(self.global_avgpool(x).flatten(1).float())


class LightConvStream(nn.Module):
    def __init__(self, c, depth):
        super().__init__()
        self.layers = nn.Sequential(*[LightConv3x3(c, c)
                                      for _ in range(depth)])

    def forward(self, x):
        return self.layers(x)


class OSBlockAIN(nn.Module):
    """osnet_ain.py's OSBlock (``inin`` False) and OSBlockINin (True: conv3
    has no BN and an affine IN follows it, inside the residual)."""

    def __init__(self, c_in, c_out, inin, reduction=4):
        super().__init__()
        mid = c_out // reduction
        self.conv1 = Conv1x1(c_in, mid)
        self.conv2 = nn.ModuleList([LightConvStream(mid, t)
                                    for t in range(1, 5)])
        self.gate = ChannelGate(mid)
        self.conv3 = Conv1x1Linear(mid, c_out, bn=not inin)
        self.downsample = (Conv1x1Linear(c_in, c_out) if c_in != c_out
                           else None)
        self.IN = nn.InstanceNorm2d(c_out, affine=True) if inin else None

    def forward(self, x):
        x1 = self.conv1(x)
        x2 = sum(self.gate(s(x1)) for s in self.conv2)
        x3 = self.conv3(x2)
        if self.IN is not None:
            x3 = self.IN(x3)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(x3 + identity)


class OSNetAIN(ReIDNet):
    """torchreid's ``osnet_ain_x1_0`` without its classifier."""

    f32_modules = ("fc",)
    feature_dim = FEATURE_DIM

    def __init__(self, name: str = "osnet_ain_x1_0"):
        super().__init__()
        c = (64, 256, 384, 512)
        self.conv1 = ConvLayer(3, c[0], 7, 2, 3, IN=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        for i, stage in enumerate(("conv2", "conv3", "conv4")):
            first, second = AIN_BLOCKS[stage]
            setattr(self, stage, nn.Sequential(
                OSBlockAIN(c[i], c[i + 1], first),
                OSBlockAIN(c[i + 1], c[i + 1], second)))
            if stage != "conv4":
                setattr(self, f"pool{i + 2}", nn.Sequential(
                    Conv1x1(c[i + 1], c[i + 1]), nn.AvgPool2d(2, 2)))
        self.conv5 = Conv1x1(c[3], c[3])
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = fc_head(c[3], FEATURE_DIM)
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.conv1(x))
        x = self.pool3(self.conv3(self.pool2(self.conv2(x))))
        x = self.conv5(self.conv4(x))
        return self.fc(self.global_avgpool(x).flatten(1).float())
