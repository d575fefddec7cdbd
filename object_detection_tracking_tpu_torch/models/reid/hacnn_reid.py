"""HA-CNN ReID net, ``hacnn`` (port of
object_detection_tracking_tpu/models/reid/hacnn_reid.py:1-154), built as
torchreid's hacnn.py builds it, for its fixed 160x64 input: ``conv`` a
3x3/2 ConvBlock (conv with bias, BN, ReLU); three global blocks
``inception1``..``3`` (InceptionA then InceptionB, 128, 256 and 384
channels), each scaled by its soft attention ``ha<i>.soft_attn`` (spatial
stream: channel mean, a 3x3/2 ConvBlock, x2 bilinear resize with
align_corners=True, a 1x1 ConvBlock; channel stream: two 1x1 ConvBlocks
over the pooled map, reduction 16; their product through ``conv``'s conv
and BN and a sigmoid, as the JAX forward computes it) and paired with a
hard attention ``ha<i>.hard_attn`` (GAP, ``fc`` to 8, tanh: a (tx, ty)
per part for 4 parts). The local branch samples each part from the
previous block's input through the affine transform [[1, 0, tx],
[0, 0.25, ty]] (``F.affine_grid``/``F.grid_sample``, bilinear, zero
padding, align_corners=False), resizes it to the block's local size
(align_corners=True), adds the previous block's local map and runs the
shared InceptionB ``local_conv<i>``. Features: ``fc_global`` over the
pooled global map and ``fc_local`` over the 4 pooled local maps (Linear,
BN1d, ReLU, 512-d each), each L2-normalized, concatenated: [B, 1024].

The affine sampling runs in float32: a bfloat16 sampling grid keeps 8
bits of each normalized coordinate (up to ~0.1 px off at 64 px), where
the JAX forward builds its hat weights in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, fc_head, init_params

CHANNELS = (128, 256, 384)
FEAT_DIM = 512
LOCAL_SIZES = ((24, 28), (12, 14), (6, 7))
REGION_SCALE = ((1.0, 0.0), (0.0, 0.25))   # hacnn.py:295-309


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, s: int = 1,
                 p: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, p)
        self.bn = nn.BatchNorm2d(c_out)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        m = c_out // 4
        for i in (1, 2, 3):
            setattr(self, f"stream{i}", nn.Sequential(
                ConvBlock(c_in, m, 1), ConvBlock(m, m, 3, p=1)))
        self.stream4 = nn.Sequential(nn.AvgPool2d(3, 1, 1),
                                     ConvBlock(c_in, m, 1))

    def forward(self, x):
        return torch.cat([self.stream1(x), self.stream2(x), self.stream3(x),
                          self.stream4(x)], 1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        m = c_out // 4
        self.stream1 = nn.Sequential(ConvBlock(c_in, m, 1),
                                     ConvBlock(m, m, 3, s=2, p=1))
        self.stream2 = nn.Sequential(ConvBlock(c_in, m, 1),
                                     ConvBlock(m, m, 3, p=1),
                                     ConvBlock(m, m, 3, s=2, p=1))
        self.stream3 = nn.Sequential(nn.MaxPool2d(3, 2, 1),
                                     ConvBlock(c_in, m * 2, 1))

    def forward(self, x):
        return torch.cat([self.stream1(x), self.stream2(x), self.stream3(x)],
                         1)


class SpatialAttn(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = ConvBlock(1, 1, 3, s=2, p=1)
        self.conv2 = ConvBlock(1, 1, 1)

    def forward(self, x):
        x = self.conv1(x.mean(1, keepdim=True))
        x = F.interpolate(x, (x.shape[2] * 2, x.shape[3] * 2),
                          mode="bilinear", align_corners=True)
        return self.conv2(x)


class ChannelAttn(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.conv1 = ConvBlock(c, c // reduction, 1)
        self.conv2 = ConvBlock(c // reduction, c, 1)

    def forward(self, x):
        return self.conv2(self.conv1(x.mean((2, 3), keepdim=True)))


class SoftAttn(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.spatial_attn = SpatialAttn()
        self.channel_attn = ChannelAttn(c)
        self.conv = ConvBlock(c, c, 1)

    def forward(self, x):
        y = self.spatial_attn(x) * self.channel_attn(x)
        return torch.sigmoid(self.conv.bn(self.conv.conv(y)))


class HardAttn(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Linear(c, 4 * 2)

    def init_params(self):
        """torchreid's start: no input dependence, the 4 parts centred at
        y = -0.75, -0.25, 0.25, 0.75."""
        nn.init.zeros_(self.fc.weight)
        with torch.no_grad():
            self.fc.bias.copy_(torch.tensor(
                [0, -0.75, 0, -0.25, 0, 0.25, 0, 0.75], dtype=torch.float32))

    def forward(self, x):
        return torch.tanh(self.fc(x.mean((2, 3)))).view(-1, 4, 2)


class HarmAttn(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.soft_attn = SoftAttn(c)
        self.hard_attn = HardAttn(c)


def stn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Each image of ``x`` resampled through [[1, 0, tx], [0, 0.25, ty]]
    (t [B, 2] = (tx, ty)), in float32; returns ``x``'s dtype."""
    theta = torch.zeros(x.shape[0], 2, 3, device=x.device)
    theta[:, :, :2] = torch.tensor(REGION_SCALE, device=x.device)
    theta[:, :, 2] = t.float()
    grid = F.affine_grid(theta, list(x.shape), align_corners=False)
    return F.grid_sample(x.float(), grid, mode="bilinear",
                         padding_mode="zeros",
                         align_corners=False).to(x.dtype)


class HACNNReID(ReIDNet):
    """torchreid's ``hacnn`` without its classifiers: images [B, 3, 160,
    64] normalized RGB -> features [B, 1024] float32."""

    def __init__(self, name: str = "hacnn"):
        super().__init__()
        self.conv = ConvBlock(3, 32, 3, s=2, p=1)
        c_in = 32
        for i, c in enumerate(CHANNELS, start=1):
            setattr(self, f"inception{i}", nn.Sequential(InceptionA(c_in, c),
                                                         InceptionB(c, c)))
            setattr(self, f"ha{i}", HarmAttn(c))
            c_in = c
        self.fc_global = fc_head(CHANNELS[-1], FEAT_DIM)
        for i, (c_prev, c) in enumerate(zip((32,) + CHANNELS, CHANNELS),
                                        start=1):
            setattr(self, f"local_conv{i}", InceptionB(c_prev, c))
        self.fc_local = fc_head(CHANNELS[-1] * 4, FEAT_DIM)
        self.feature_dim = FEAT_DIM * 2
        init_params(self)
        for i in (1, 2, 3):
            getattr(self, f"ha{i}").hard_attn.init_params()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[2:]) != (160, 64):
            raise ValueError("hacnn requires 160x64 input crops "
                             f"(got {tuple(x.shape[2:])})")
        cur = self.conv(x)
        local = [None] * 4
        for i in (1, 2, 3):
            g = getattr(self, f"inception{i}")(cur)
            ha = getattr(self, f"ha{i}")
            attn, theta = ha.soft_attn(g), ha.hard_attn(g)
            local_conv = getattr(self, f"local_conv{i}")
            for r in range(4):
                t = F.interpolate(stn(cur, theta[:, r]), LOCAL_SIZES[i - 1],
                                  mode="bilinear", align_corners=True)
                if local[r] is not None:
                    t = t + local[r]
                local[r] = local_conv(t)
            cur = g * attn
        v_g = self.fc_global(cur.mean((2, 3)))
        v_l = self.fc_local(torch.cat([t.mean((2, 3)) for t in local], 1))
        v_g = v_g / v_g.norm(p=2, dim=1, keepdim=True)
        v_l = v_l / v_l.norm(p=2, dim=1, keepdim=True)
        return torch.cat([v_g, v_l], 1).float()
