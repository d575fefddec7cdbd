"""MLFN ReID net, ``mlfn`` (port of
object_detection_tracking_tpu/models/reid/mlfn_reid.py:1-66), built as
torchreid's mlfn.py builds it: a 7x7/2 ``conv1`` with bias, BN, ReLU and
a 3x3/2 max pool; ``feature``, 16 MLFN blocks (stride 2 at blocks 3, 7
and 13). Each block's factor module (1x1 ``fm_conv1``, grouped 3x3
``fm_conv2`` in 32 groups, 1x1 ``fm_conv3``, each with BN and ReLU) is
scaled between its 3x3 and last 1x1 by the factor-selection module
``fsm`` (GAP, two 1x1+BN+ReLU, a 1x1 to 32 gates, BN, sigmoid): group g's
contiguous channels all take gate g. The embedding is (``fc_x`` over the
pooled last map + ``fc_s`` over the 16 blocks' 512 gates) * 0.5, 1024-d.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, init_params

GROUPS = 32
CHANNELS = (64, 256, 512, 1024, 2048)
# (blocks, fsm channels) of each stage after the stem (mlfn.py:128-176)
STAGES = ((3, (128, 64)), (4, (256, 128)), (6, (512, 128)),
          (3, (512, 128)))


def _cbr(c_in: int, c_out: int, bias: bool = True):
    return [nn.Conv2d(c_in, c_out, 1, bias=bias), nn.BatchNorm2d(c_out),
            nn.ReLU(inplace=True)]


class MLFNBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, fsm_channels):
        super().__init__()
        mid = c_out // 2
        self.fm_conv1 = nn.Conv2d(c_in, mid, 1, bias=False)
        self.fm_bn1 = nn.BatchNorm2d(mid)
        self.fm_conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False,
                                  groups=GROUPS)
        self.fm_bn2 = nn.BatchNorm2d(mid)
        self.fm_conv3 = nn.Conv2d(mid, c_out, 1, bias=False)
        self.fm_bn3 = nn.BatchNorm2d(c_out)
        f0, f1 = fsm_channels
        self.fsm = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), *_cbr(c_in, f0), *_cbr(f0, f1),
            nn.Conv2d(f1, GROUPS, 1), nn.BatchNorm2d(GROUPS), nn.Sigmoid())
        self.downsample = None
        if c_in != c_out or stride > 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(c_in, c_out, 1, stride, bias=False),
                nn.BatchNorm2d(c_out))

    def forward(self, x):
        s = self.fsm(x)                                   # [B, 32, 1, 1]
        out = F.relu(self.fm_bn1(self.fm_conv1(x)))
        out = F.relu(self.fm_bn2(self.fm_conv2(out)))
        out = out * s.repeat_interleave(out.shape[1] // GROUPS, dim=1)
        out = F.relu(self.fm_bn3(self.fm_conv3(out)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(residual + out), s


class MLFNReID(ReIDNet):
    """torchreid's ``mlfn`` without its classifier: images [B, 3, H, W]
    normalized RGB -> features [B, 1024] float32."""

    def __init__(self, name: str = "mlfn", embed_dim: int = 1024):
        super().__init__()
        self.conv1 = nn.Conv2d(3, CHANNELS[0], 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(CHANNELS[0])
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        blocks, c_in = [], CHANNELS[0]
        for si, (n, fsm) in enumerate(STAGES):
            c_out = CHANNELS[si + 1]
            for b in range(n):
                blocks.append(MLFNBlock(c_in, c_out,
                                        2 if si > 0 and b == 0 else 1, fsm))
                c_in = c_out
        self.feature = nn.ModuleList(blocks)
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc_x = nn.Sequential(*_cbr(c_in, embed_dim, bias=False))
        self.fc_s = nn.Sequential(*_cbr(GROUPS * len(blocks), embed_dim,
                                        bias=False))
        self.feature_dim = embed_dim
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        gates = []
        for block in self.feature:
            x, s = block(x)
            gates.append(s)
        v = (self.fc_x(self.global_avgpool(x))
             + self.fc_s(torch.cat(gates, 1))) * 0.5
        return v.flatten(1).float()
