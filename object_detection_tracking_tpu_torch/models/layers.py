"""Layers over parameters named as in the JAX param tree (port of
object_detection_tracking_tpu/models/layers.py:68-142).

``Conv`` holds ``weight`` [O, I/groups, kh, kw] (the JAX tree's HWIO ``W``,
transposed by params.py) and an optional ``bias`` (``b``) and ``bn``; the
TF-style asymmetric padding is an explicit ``F.pad`` before an unpadded
conv, since torch pads symmetrically. ``nn.Linear`` carries ``dense``'s
``W`` [in, out] transposed. Parameters stay float32 and are cast to the
activation's dtype at use, as the JAX layers cast ``W`` to ``x.dtype``.
Activations are NCHW (channels_last memory) inside the backbone.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import FrozenBN

# ((top, bottom), (left, right)), as the JAX layers take it
Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]


class Conv(nn.Module):
    """Conv parameters (and its BN); applied with ``conv2d``."""

    def __init__(self, kernel: int, c_in: int, c_out: int,
                 use_bias: bool = True, groups: int = 1, bn: bool = False):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(
            torch.zeros(c_out, c_in // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(c_out)) if use_bias else None
        self.bn = FrozenBN(c_out) if bn else None


def conv2d(p: Conv, x: torch.Tensor, stride: int = 1,
           padding: Padding = "SAME", dilation: int = 1) -> torch.Tensor:
    """NCHW conv. padding: 'SAME' (stride-1 only: (k-1)*d/2 each side),
    'VALID', or explicit ((top, bottom), (left, right))."""
    k = p.weight.shape[-1]
    if padding == "SAME":
        if stride != 1:
            raise ValueError("SAME padding is only used with stride 1")
        pad = (k - 1) * dilation // 2
        pads = (pad, pad, pad, pad)
    elif padding == "VALID":
        pads = (0, 0, 0, 0)
    else:
        (t, b), (l, r) = padding
        pads = (l, r, t, b)
    if pads[0] == pads[1] and pads[2] == pads[3]:
        conv_pad = (pads[2], pads[0])
    else:
        x = F.pad(x, pads)
        conv_pad = (0, 0)
    bias = p.bias.to(x.dtype) if p.bias is not None else None
    return F.conv2d(x, p.weight.to(x.dtype), bias, stride, conv_pad,
                    dilation, p.groups)


def dense(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Dense over the last axis; >2D inputs flatten to [N, -1] first in
    their own (NHWC-major for ROI features) order, which fc6's rows follow
    (JAX layers.py:88-97)."""
    if x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, p.weight.to(x.dtype), p.bias.to(x.dtype))


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None
             ) -> torch.Tensor:
    """NCHW max pool; explicit padding pads with -inf (JAX layers.py:100)."""
    if padding is not None:
        (t, b), (l, r) = padding
        x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def deconv2d(p: Conv, x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """NCHW transposed conv of the JAX ``deconv2d`` (layers.py:145-153):
    ``jax.lax.conv_transpose`` with "SAME" padding and
    ``transpose_kernel=False`` on an HWIO kernel, for a kernel as large as
    the stride (the mask head's 2x2/2). That op correlates the
    stride-dilated input with the kernel unflipped, so output pixel
    s*i + d takes tap s-1-d of input pixel i: as ``F.conv_transpose2d``
    it is the spatially flipped kernel with in and out swapped."""
    if p.weight.shape[-1] != stride:
        raise NotImplementedError("deconv2d takes kernel size == stride")
    w = p.weight.flip(2, 3).transpose(0, 1).to(x.dtype)
    bias = p.bias.to(x.dtype) if p.bias is not None else None
    return F.conv_transpose2d(x, w, bias, stride=stride)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling, NCHW."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
