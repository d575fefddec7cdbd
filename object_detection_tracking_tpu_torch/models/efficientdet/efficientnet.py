"""EfficientNet-B0..B7 and lite0..lite4 backbone, inference forward (port
of object_detection_tracking_tpu/models/efficientdet/efficientnet.py).

Stem conv 3x3/2 + MBConv block groups with squeeze-excite and swish,
width/depth compound scaling with the divisor-8 filter rounding; returns
the C3/C4/C5 endpoints for the BiFPN. Lite variants: relu6, no SE, and
fix_head_stem (the stem stays 32 filters, the first and last block groups
keep unscaled repeats).

Module and parameter names follow the JAX tree (``stem``,
``group{g}.block{b}.{expand,dw,se_reduce,se_expand,project}``), so
params.py maps them one to one; a depthwise kernel is a grouped ``Conv``
(HWIO [k, k, 1, C] <-> [C, 1, k, k]). The TF-SAME padding of the stem
``((0, 1), (0, 1))`` and of the stride-2 depthwise convs ``(k//2 - 1,
k//2)`` is an explicit ``F.pad`` before an unpadded conv (layers.conv2d).
Activations NCHW.
"""

from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from ...ops.norm import frozen_bn
from ..layers import Conv, conv2d

# (kernel, stride, expand, in_filters, out_filters, repeats) for B0
BLOCK_ARGS = [
    (3, 1, 1, 32, 16, 1),
    (3, 2, 6, 16, 24, 2),
    (5, 2, 6, 24, 40, 2),
    (3, 2, 6, 40, 80, 3),
    (5, 1, 6, 80, 112, 3),
    (5, 2, 6, 112, 192, 4),
    (3, 1, 6, 192, 320, 1),
]
SE_RATIO = 0.25

# width_coefficient, depth_coefficient (automl efficientnet_builder.py,
# efficientnet_lite_builder.py)
SCALING = {
    "efficientnet-b0": (1.0, 1.0),
    "efficientnet-b1": (1.0, 1.1),
    "efficientnet-b2": (1.1, 1.2),
    "efficientnet-b3": (1.2, 1.4),
    "efficientnet-b4": (1.4, 1.8),
    "efficientnet-b5": (1.6, 2.2),
    "efficientnet-b6": (1.8, 2.6),
    "efficientnet-b7": (2.0, 3.1),
    "efficientnet-lite0": (1.0, 1.0),
    "efficientnet-lite1": (1.0, 1.1),
    "efficientnet-lite2": (1.1, 1.2),
    "efficientnet-lite3": (1.2, 1.4),
    "efficientnet-lite4": (1.4, 1.8),
}


def is_lite(model_name: str) -> bool:
    return "lite" in model_name


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def scaled_block_args(model_name: str):
    w, d = SCALING[model_name]
    lite = is_lite(model_name)
    out = []
    for gi, (k, s, e, i, o, r) in enumerate(BLOCK_ARGS):
        # lite fix_head_stem: first/last groups keep unscaled repeats
        rr = r if lite and gi in (0, len(BLOCK_ARGS) - 1) \
            else round_repeats(r, d)
        out.append((k, s, e, round_filters(i, w), round_filters(o, w), rr))
    return out


def stem_channels(model_name: str) -> int:
    """The stem's filters: 32 unscaled in lite (fix_head_stem)."""
    return 32 if is_lite(model_name) else round_filters(
        32, SCALING[model_name][0])


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_max(torch.relu(x), 6.0)


class MBConvBlock(nn.Module):
    """One MBConv's parameters, named as the JAX tree's block."""

    def __init__(self, kernel: int, expand: int, cin: int, cout: int,
                 use_se: bool = True):
        super().__init__()
        mid = cin * expand
        if expand != 1:
            self.expand = Conv(1, cin, mid, use_bias=False, bn=True)
        self.dw = Conv(kernel, mid, mid, use_bias=False, groups=mid, bn=True)
        if use_se:
            se_ch = max(1, int(cin * SE_RATIO))
            self.se_reduce = Conv(1, mid, se_ch)
            self.se_expand = Conv(1, se_ch, mid)
        self.project = Conv(1, mid, cout, use_bias=False, bn=True)


def _maybe_se(p: MBConvBlock, x: torch.Tensor, act) -> torch.Tensor:
    """Squeeze-excite when the block has SE params (lite blocks don't)."""
    if not hasattr(p, "se_reduce"):
        return x
    se = x.mean(dim=(2, 3), keepdim=True)
    se = act(conv2d(p.se_reduce, se))
    se = torch.sigmoid(conv2d(p.se_expand, se))
    return x * se


def mbconv(p: MBConvBlock, x: torch.Tensor, kernel: int, stride: int,
           expand: int, act=swish, bn=frozen_bn) -> torch.Tensor:
    inp = x
    if expand != 1:
        x = act(bn(p.expand.bn, conv2d(p.expand, x)))
    pad = kernel // 2
    x = conv2d(p.dw, x, stride=stride, padding=((pad, pad), (pad, pad)))
    x = act(bn(p.dw.bn, x))
    x = _maybe_se(p, x, act)
    x = bn(p.project.bn, conv2d(p.project, x))
    if stride == 1 and inp.shape[1] == x.shape[1]:
        x = x + inp
    return x


def mbconv_stride2(p: MBConvBlock, x: torch.Tensor, kernel: int,
                   expand: int, act=swish, bn=frozen_bn) -> torch.Tensor:
    """MBConv with a stride-2 depthwise conv, TF SAME padding on even
    extents: (k//2 - 1, k//2)."""
    if expand != 1:
        x = act(bn(p.expand.bn, conv2d(p.expand, x)))
    lo, hi = kernel // 2 - 1, kernel // 2
    x = conv2d(p.dw, x, stride=2, padding=((lo, hi), (lo, hi)))
    x = act(bn(p.dw.bn, x))
    x = _maybe_se(p, x, act)
    return bn(p.project.bn, conv2d(p.project, x))


class EfficientNet(nn.Module):
    """``stem`` and ``group{g}`` of ``block{b}``, as the JAX tree."""

    def __init__(self, model_name: str):
        super().__init__()
        self.model_name = model_name
        self.args = scaled_block_args(model_name)
        use_se = not is_lite(model_name)
        cin = stem_channels(model_name)
        self.stem = Conv(3, 3, cin, use_bias=False, bn=True)
        for gi, (k, _s, e, _i, o, r) in enumerate(self.args):
            self.add_module(f"group{gi}", nn.ModuleDict({
                f"block{bi}": MBConvBlock(k, e, cin if bi == 0 else o, o,
                                          use_se=use_se)
                for bi in range(r)}))
            cin = o

    def forward(self, images: torch.Tensor, bn=frozen_bn
                ) -> List[torch.Tensor]:
        return efficientnet_c345(self, images, self.model_name, bn=bn)


def efficientnet_c345(params: EfficientNet, images: torch.Tensor,
                      model_name: str, bn=frozen_bn) -> List[torch.Tensor]:
    """images [B, 3, H, W] (H, W multiples of 128) -> [C3, C4, C5]
    (strides 8, 16, 32), NCHW."""
    act = relu6 if is_lite(model_name) else swish
    x = conv2d(params.stem, images, stride=2, padding=((0, 1), (0, 1)))
    x = act(bn(params.stem.bn, x))
    endpoints = []
    for gi, (k, s, e, _i, _o, r) in enumerate(params.args):
        group = getattr(params, f"group{gi}")
        for bi in range(r):
            stride = s if bi == 0 else 1
            pd = group[f"block{bi}"]
            if stride == 2:
                endpoints.append(x)  # the feature before this reduction
                x = mbconv_stride2(pd, x, k, e, act=act, bn=bn)
            else:
                x = mbconv(pd, x, k, stride, e, act=act, bn=bn)
    endpoints.append(x)
    # endpoints: [C1(s2), C2(s4), C3(s8), C4(s16), C5(s32)]
    return endpoints[-3:]
