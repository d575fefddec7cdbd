"""NASNet-A-Mobile ReID net, ``nasnetamobile`` (and the reference
registry's typo ``nasnsetmobile``; port of
object_detection_tracking_tpu/models/reid/nasnet_reid.py:1-181), built as
torchreid's nasnet.py (the Cadene NASNet-A (4 @ 1056)) builds it:
``conv0`` an unpadded 3x3/2 conv and BN; ``cell_stem_0`` and
``cell_stem_1``; three stages of a FirstCell and 3 NormalCells
(``cell_0``..``cell_3``, ``cell_6``..``cell_9``, ``cell_12``..
``cell_15``) joined by ``reduction_cell_0`` and ``reduction_cell_1``;
ReLU and GAP features, 1056-d. Every BN has eps 1e-3; no conv has a bias.

The TF graph's same-padding, reproduced as the Cadene module does
(JAX :26-85): MaxPoolPad and AvgPoolPad pad a zero row on top and a zero
column on the left, pool 3x3/2 with padding 1 and drop the first row and
column; the "specific" and reduction separable branches pad the same way
before their strided depthwise conv and crop after it; the second
stride-2 path of a FirstCell or CellStem1 reads the input shifted by one
pixel up and left (pad right/bottom, drop the first row and column).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ReIDNet, init_params

BN_EPS = 1e-3
STEM_FILTERS = 32
PENULTIMATE = 1056


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)


def _pad_tl(x):
    return F.pad(x, (1, 0, 1, 0))


def _avg3(x, stride: int = 1):
    return F.avg_pool2d(x, 3, stride, 1, count_include_pad=False)


def max_pool_pad(x):
    return F.max_pool2d(_pad_tl(x), 3, 2, 1)[:, :, 1:, 1:]


def avg_pool_pad(x):
    return _avg3(_pad_tl(x), 2)[:, :, 1:, 1:]


class SeparableConv2d(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 padding: int):
        super().__init__()
        self.depthwise_conv2d = nn.Conv2d(c_in, c_in, k, stride, padding,
                                          groups=c_in, bias=False)
        self.pointwise_conv2d = nn.Conv2d(c_in, c_out, 1, bias=False)

    def forward(self, x):
        return self.pointwise_conv2d(self.depthwise_conv2d(x))


class BranchSeparables(nn.Module):
    """ReLU, separable (k, stride), BN, ReLU, separable (k, 1), BN. With
    ``stem`` the first separable changes the width (BranchSeparablesStem),
    else the second; with ``shift`` the first is padded top-left and
    cropped ("specific", BranchSeparablesReduction)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 shift: bool = False, stem: bool = False):
        super().__init__()
        c_mid = c_out if stem else c_in
        self.shift = shift
        self.separable_1 = SeparableConv2d(c_in, c_mid, k, stride, k // 2)
        self.bn_sep_1 = _bn(c_mid)
        self.separable_2 = SeparableConv2d(c_mid, c_out, k, 1, k // 2)
        self.bn_sep_2 = _bn(c_out)

    def forward(self, x):
        x = F.relu(x)
        if self.shift:
            x = self.separable_1(_pad_tl(x))[:, :, 1:, 1:]
        else:
            x = self.separable_1(x)
        x = F.relu(self.bn_sep_1(x))
        return self.bn_sep_2(self.separable_2(x))


def relu_conv_bn(c_in: int, c_out: int) -> nn.Sequential:
    """The cells' ``conv_1x1``/``conv_prev_1x1``: ReLU, 1x1 conv, BN."""
    s = nn.Sequential()
    s.add_module("relu", nn.ReLU())
    s.add_module("conv", nn.Conv2d(c_in, c_out, 1, bias=False))
    s.add_module("bn", _bn(c_out))
    return s


class ShiftedPaths(nn.Module):
    """ReLU, then two stride-2 1x1 paths (the second on the input shifted
    by one pixel), concatenated and batch-normed: the ``path_1``,
    ``path_2`` and ``final_path_bn`` of FirstCell and CellStem1."""

    def _paths(self, c_in: int, c_half: int):
        self.path_1 = nn.Sequential()
        self.path_1.add_module("avgpool", nn.AvgPool2d(1, 2))
        self.path_1.add_module("conv", nn.Conv2d(c_in, c_half, 1,
                                                 bias=False))
        self.path_2 = nn.ModuleList()
        self.path_2.add_module("pad", nn.ZeroPad2d((0, 1, 0, 1)))
        self.path_2.add_module("avgpool", nn.AvgPool2d(1, 2))
        self.path_2.add_module("conv", nn.Conv2d(c_in, c_half, 1,
                                                 bias=False))
        self.final_path_bn = _bn(2 * c_half)

    def shifted_paths(self, x):
        x = F.relu(x)
        p1 = self.path_1.conv(x[:, :, ::2, ::2])
        xs = F.pad(x, (0, 1, 0, 1))[:, :, 1:, 1:]
        p2 = self.path_2.conv(xs[:, :, ::2, ::2])
        return self.final_path_bn(torch.cat([p1, p2], 1))


class CellStem0(nn.Module):
    def __init__(self, c_stem: int, f: int):
        super().__init__()
        self.conv_1x1 = relu_conv_bn(c_stem, f)
        self.comb_iter_0_left = BranchSeparables(f, f, 5, 2)
        self.comb_iter_0_right = BranchSeparables(c_stem, f, 7, 2, stem=True)
        self.comb_iter_1_right = BranchSeparables(c_stem, f, 7, 2, stem=True)
        self.comb_iter_2_right = BranchSeparables(c_stem, f, 5, 2, stem=True)
        self.comb_iter_4_left = BranchSeparables(f, f, 3, 1)

    def forward(self, x):
        x1 = self.conv_1x1(x)
        c0 = self.comb_iter_0_left(x1) + self.comb_iter_0_right(x)
        c1 = F.max_pool2d(x1, 3, 2, 1) + self.comb_iter_1_right(x)
        c2 = _avg3(x1, 2) + self.comb_iter_2_right(x)
        c3 = _avg3(c0) + c1
        c4 = self.comb_iter_4_left(c0) + F.max_pool2d(x1, 3, 2, 1)
        return torch.cat([c1, c2, c3, c4], 1)


class ReductionComb(nn.Module):
    """The comb of CellStem1 and the reduction cells over (left, right):
    the pools and ``comb_iter_4_left`` read ``left``."""

    def _combs(self, f: int):
        self.comb_iter_0_left = BranchSeparables(f, f, 5, 2, shift=True)
        self.comb_iter_0_right = BranchSeparables(f, f, 7, 2, shift=True)
        self.comb_iter_1_right = BranchSeparables(f, f, 7, 2, shift=True)
        self.comb_iter_2_right = BranchSeparables(f, f, 5, 2, shift=True)
        self.comb_iter_4_left = BranchSeparables(f, f, 3, 1, shift=True)

    def comb(self, left, right):
        c0 = self.comb_iter_0_left(left) + self.comb_iter_0_right(right)
        c1 = max_pool_pad(left) + self.comb_iter_1_right(right)
        c2 = avg_pool_pad(left) + self.comb_iter_2_right(right)
        c3 = _avg3(c0) + c1
        c4 = self.comb_iter_4_left(c0) + max_pool_pad(left)
        return torch.cat([c1, c2, c3, c4], 1)


class CellStem1(ShiftedPaths, ReductionComb):
    def __init__(self, c_stem: int, f: int):
        super().__init__()
        self.conv_1x1 = relu_conv_bn(2 * f, f)
        self._paths(c_stem, f // 2)
        self._combs(f)

    def forward(self, x_conv0, x_stem_0):
        return self.comb(self.conv_1x1(x_stem_0),
                         self.shifted_paths(x_conv0))


class ReductionCell(ReductionComb):
    def __init__(self, c_left: int, c_right: int, f: int):
        super().__init__()
        self.conv_prev_1x1 = relu_conv_bn(c_left, f)
        self.conv_1x1 = relu_conv_bn(c_right, f)
        self._combs(f)

    def forward(self, x, x_prev):
        return self.comb(self.conv_1x1(x), self.conv_prev_1x1(x_prev))


class NormalComb(nn.Module):
    def _combs(self, f_left: int, f_right: int):
        self.comb_iter_0_left = BranchSeparables(f_right, f_right, 5, 1)
        self.comb_iter_0_right = BranchSeparables(f_left, f_left, 3, 1)
        self.comb_iter_1_left = BranchSeparables(f_left, f_left, 5, 1)
        self.comb_iter_1_right = BranchSeparables(f_left, f_left, 3, 1)
        self.comb_iter_4_left = BranchSeparables(f_right, f_right, 3, 1)

    def comb(self, left, right):
        c0 = self.comb_iter_0_left(right) + self.comb_iter_0_right(left)
        c1 = self.comb_iter_1_left(left) + self.comb_iter_1_right(left)
        c2 = _avg3(right) + left
        c3 = _avg3(left) + _avg3(left)
        c4 = self.comb_iter_4_left(right) + right
        return torch.cat([left, c0, c1, c2, c3, c4], 1)


class FirstCell(ShiftedPaths, NormalComb):
    def __init__(self, c_left: int, f_left: int, c_right: int,
                 f_right: int):
        super().__init__()
        self.conv_1x1 = relu_conv_bn(c_right, f_right)
        self._paths(c_left, f_left)
        self._combs(f_right, f_right)

    def forward(self, x, x_prev):
        return self.comb(self.shifted_paths(x_prev), self.conv_1x1(x))


class NormalCell(NormalComb):
    def __init__(self, c_left: int, f_left: int, c_right: int,
                 f_right: int):
        super().__init__()
        self.conv_prev_1x1 = relu_conv_bn(c_left, f_left)
        self.conv_1x1 = relu_conv_bn(c_right, f_right)
        self._combs(f_left, f_right)

    def forward(self, x, x_prev):
        return self.comb(self.conv_prev_1x1(x_prev), self.conv_1x1(x))


class NASNetAMobileReID(ReIDNet):
    """torchreid's ``nasnetamobile`` without its classifier: images
    [B, 3, H, W] normalized RGB -> features [B, 1056] float32."""

    def __init__(self, name: str = "nasnetamobile"):
        super().__init__()
        f = PENULTIMATE // 24                            # 44
        self.conv0 = nn.Sequential()
        self.conv0.add_module("conv", nn.Conv2d(3, STEM_FILTERS, 3, 2, 0,
                                                bias=False))
        self.conv0.add_module("bn", _bn(STEM_FILTERS))
        self.cell_stem_0 = CellStem0(STEM_FILTERS, f // 4)
        self.cell_stem_1 = CellStem1(STEM_FILTERS, f // 2)
        # (first cell's x_prev width, x width, filters) per stage
        for stage, (c_prev, c_x, g) in enumerate(
                ((f, 2 * f, f), (6 * f, 8 * f, 2 * f),
                 (12 * f, 16 * f, 4 * f))):
            first = 6 * stage
            setattr(self, f"cell_{first}",
                    FirstCell(c_prev, g // 2, c_x, g))
            setattr(self, f"cell_{first + 1}",
                    NormalCell(c_x, g, 6 * g, g))
            for i in (2, 3):
                setattr(self, f"cell_{first + i}",
                        NormalCell(6 * g, g, 6 * g, g))
            if stage < 2:
                setattr(self, f"reduction_cell_{stage}",
                        ReductionCell(6 * g, 6 * g, 2 * g))
        self.feature_dim = 24 * f
        init_params(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_conv0 = self.conv0(x)
        x_stem_0 = self.cell_stem_0(x_conv0)
        prev, cur = x_stem_0, self.cell_stem_1(x_conv0, x_stem_0)
        for stage in range(3):
            first = 6 * stage
            for i in range(4):
                cell = getattr(self, f"cell_{first + i}")
                prev, cur = cur, cell(cur, prev)
            if stage < 2:
                red = getattr(self, f"reduction_cell_{stage}")
                prev, cur = cur, red(cur, prev)
        return F.relu(cur).mean((2, 3)).float()
