"""ResNet backbone (18/34/50/101/152, dilated c5, SE, ResNeXt) producing
c2..c5 (port of object_detection_tracking_tpu/models/resnet.py:105-290).

Geometry matches the JAX backbone exactly (off-by-one here silently
shifts every box):
  * 7x7/2 stem over the padded image with padding ((3, 2), (3, 2)); the JAX
    package's space-to-depth stem is the same conv in a TPU layout, so the
    port runs the plain conv;
  * pad (1, 0) with -inf + 3x3/2 max pool;
  * stride-2 3x3: pad (1, 0) + VALID; with dilation 2 an extra zero (1, 0)
    pad after conv2 (reference nn.py:489-500);
  * stride-2 shortcut: plain 1x1/2 VALID (the padded extents are even).
Module and parameter names follow the JAX tree (``group0.block0.conv1``...),
so params.py maps them one to one. Activations NCHW, channels_last memory.

``use_deformable`` gives the last ``modified_block_num`` blocks of groups
1-3 a deformable conv2 (``conv2_offset``, JAX resnet.py:94-100, :118-124):
its taps sampled at offsets from a side conv (models/deformable.py), at
stride 2 in a lead block, where the block's dilation and the stride-2
padding of the plain conv2 do not apply.

``fused_stages`` (config.backbone_impl="pallas") keeps the JAX gate
(resnet.py:244-282): in a plain bottleneck ResNet (no SE, no ResNeXt),
each group of dilation 1 with no deformable block (JAX resnet.py:253-254)
runs its stride-2 lead block unfused and its stride-1 tail through the
bottleneck-stage kernel (ops/resnet_stage.py), once per group. At R101 v4
that is c2, c3 and c4 (3 launches a forward); with ``use_deformable`` c2
alone (1 launch), c3 and c4 running unfused, c5 dilated as before. The
JAX path's ``_fusable_rows`` and ``_pick_tr >= 4`` fallbacks are TPU VMEM
limits and are left out (ROADMAP C6): every eligible tail is fused.
Training runs the unfused blocks (the model builds its ResNet without
``fused_stages`` when ``is_train``, JAX faster_rcnn.py:276-277).

``freeze`` is JAX's gradient cut (resnet.py:287-288): the stem and groups
0..freeze run under ``torch.no_grad()``, so their outputs carry no
gradient, as ``stop_gradient`` after group ``freeze`` gives in JAX. Their
parameters end a backward with no ``.grad``; the trainer fills zeros, as
``jax.grad`` returns for them.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch
from torch import nn

from ..ops.norm import bn_relu, frozen_bn
from ..ops.resnet_stage import fused_bottleneck_stage_cuda
from .deformable import deformable_conv2d
from .layers import Conv, conv2d, dense, max_pool

_STRIDE2_PAD = ((1, 0), (1, 0))


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, ch_out: int, stride: int, dilation: int,
                 use_se: bool, use_resnext: bool, deformable: bool = False):
        super().__init__()
        groups = 32 if use_resnext else 1
        width = ch_out * 2 if use_resnext else ch_out
        self.stride, self.dilation = stride, dilation
        self.conv1 = Conv(1, c_in, width, use_bias=False, bn=True)
        self.conv2 = Conv(3, width, width, use_bias=False, groups=groups,
                          bn=True)
        self.conv3 = Conv(1, width, ch_out * 4, use_bias=False, bn=True)
        self.conv2_offset = Conv(3, width, 18) if deformable else None
        if c_in != ch_out * 4:
            self.convshortcut = Conv(1, c_in, ch_out * 4, use_bias=False,
                                     bn=True)
        else:
            self.convshortcut = None
        if use_se:
            self.fc1 = nn.Linear(ch_out * 4, ch_out // 4)
            self.fc2 = nn.Linear(ch_out // 4, ch_out * 4)
        else:
            self.fc1 = self.fc2 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        l = bn_relu(self.conv1.bn, conv2d(self.conv1, x))
        if self.conv2_offset is not None:
            l = deformable_conv2d(self.conv2_offset, self.conv2.weight, l,
                                  stride=self.stride)
            l = bn_relu(self.conv2.bn, l)
        elif self.stride == 2:
            l = conv2d(self.conv2, l, stride=2, padding=_STRIDE2_PAD,
                       dilation=self.dilation)
            l = bn_relu(self.conv2.bn, l)
            if self.dilation != 1:
                # the reference pads an extra (1, 0) to recover H/2
                l = nn.functional.pad(l, (1, 0, 1, 0))
        else:
            l = conv2d(self.conv2, l, dilation=self.dilation)
            l = bn_relu(self.conv2.bn, l)
        l = frozen_bn(self.conv3.bn, conv2d(self.conv3, l))
        if self.fc1 is not None:
            sq = l.mean(dim=(2, 3)).float()
            sq = torch.relu(dense(self.fc1, sq))
            sq = torch.sigmoid(dense(self.fc2, sq))
            l = l * sq[:, :, None, None].to(l.dtype)
        if self.convshortcut is not None:
            sc = conv2d(self.convshortcut, x, stride=self.stride,
                        padding="VALID")
            sc = frozen_bn(self.convshortcut.bn, sc)
        else:
            sc = x
        return torch.relu(l + sc)


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, ch_out: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv(3, c_in, ch_out, use_bias=False, bn=True)
        self.conv2 = Conv(3, ch_out, ch_out, use_bias=False, bn=True)
        self.convshortcut = (Conv(1, c_in, ch_out, use_bias=False, bn=True)
                             if c_in != ch_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            l = conv2d(self.conv1, x, stride=2, padding=_STRIDE2_PAD)
        else:
            l = conv2d(self.conv1, x)
        l = bn_relu(self.conv1.bn, l)
        l = frozen_bn(self.conv2.bn, conv2d(self.conv2, l))
        if self.convshortcut is not None:
            sc = conv2d(self.convshortcut, x, stride=self.stride,
                        padding="VALID")
            sc = frozen_bn(self.convshortcut.bn, sc)
        else:
            sc = x
        return torch.relu(l + sc)


class ResNet(nn.Module):
    """c2..c5 backbone; ``fused_stages`` runs the stride-1 bottleneck tails
    through the bottleneck-stage kernel (module note)."""

    def __init__(self, num_blocks: Sequence[int], use_basic_block: bool,
                 use_dilations: bool = False, use_se: bool = False,
                 use_resnext: bool = False, use_deformable: bool = False,
                 fused_stages: bool = False, modified_block_num: int = 3):
        super().__init__()
        self.conv0 = Conv(7, 3, 64, use_bias=False, bn=True)
        c_in = 64
        fuse = (fused_stages and not use_basic_block and not use_se
                and not use_resnext)
        self.fused_groups = []
        for gi, (count, feat) in enumerate(zip(num_blocks,
                                               (64, 128, 256, 512))):
            stride = 1 if gi == 0 else 2
            dilation = 2 if (use_dilations and gi == 3) else 1
            group = nn.ModuleDict()
            for bi in range(count):
                s = stride if bi == 0 else 1
                if use_basic_block:
                    group[f"block{bi}"] = BasicBlock(c_in, feat, s)
                    c_in = feat
                else:
                    modified = bi >= count - modified_block_num
                    d = dilation if modified else 1
                    group[f"block{bi}"] = Bottleneck(
                        c_in, feat, s, d, use_se, use_resnext,
                        deformable=use_deformable and gi >= 1 and modified)
                    c_in = feat * 4
            self.add_module(f"group{gi}", group)
            if fuse and dilation == 1 and not any(
                    b.conv2_offset is not None for b in group.values()):
                self.fused_groups.append(gi)
        self.num_groups = len(num_blocks)

    def forward(self, image: torch.Tensor, freeze: int = -1
                ) -> List[torch.Tensor]:
        """image: [B, 3, Hp, Wp] padded, normalized, compute dtype; the stem
        and groups 0..freeze run without gradients (module note).
        Returns [c2, c3, c4, c5] NCHW."""
        def cut(gi):
            return (torch.no_grad() if freeze >= gi
                    else contextlib.nullcontext())

        with cut(0):
            l = conv2d(self.conv0, image, stride=2, padding=((3, 2), (3, 2)))
            l = bn_relu(self.conv0.bn, l)
            l = max_pool(l, 3, 2, padding=((1, 0), (1, 0)))
        outs = []
        for gi in range(self.num_groups):
            with cut(gi):
                l = self._group(gi, l)
            outs.append(l)
        return outs

    def _group(self, gi: int, l: torch.Tensor) -> torch.Tensor:
        blocks = list(getattr(self, f"group{gi}").values())
        if gi in self.fused_groups:
            if blocks[0].stride != 1:   # the kernel is stride-1 only
                l = blocks[0](l)
                blocks = blocks[1:]
            if blocks:
                # channels_last NCHW is NHWC memory: no copy either way
                width = blocks[0].conv1.weight.shape[0]
                l = fused_bottleneck_stage_cuda(
                    blocks, l.permute(0, 2, 3, 1).contiguous(), width,
                    4 * width).permute(0, 3, 1, 2)
        else:
            for block in blocks:
                l = block(l)
        return l
