"""Frozen BatchNorm (port of object_detection_tracking_tpu/ops/norm.py:26-38).

Stored EMA statistics applied with eps=1e-5 (reference nn.py:1722-1792).
The affine folds into one scale/offset pair computed in f32 from the f32
leaves, then applied in the activation's dtype — as the JAX op does.
Activations are NCHW here (channels_last memory inside the backbone).

In training, JAX differentiates every leaf of the param tree, so all four
statistics of a BN outside the frozen groups take gradients and optimizer
updates (JAX ops/norm.py:26-34 has no stop_gradient). They are therefore
``nn.Parameter``s here, created with ``requires_grad=False``: a model built
for training (``FasterRCNNFPN`` with ``is_train``) turns gradients on for
every parameter.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5


class FrozenBN(nn.Module):
    """BN statistics (parameters gamma/beta/mean/variance, named as in the
    JAX param tree); applied with ``frozen_bn``/``bn_relu``."""

    def __init__(self, c: int):
        super().__init__()
        for name, value in (("gamma", torch.ones(c)), ("beta", torch.zeros(c)),
                            ("mean", torch.zeros(c)),
                            ("variance", torch.ones(c))):
            setattr(self, name, nn.Parameter(value, requires_grad=False))


def frozen_bn(bn: FrozenBN, x: torch.Tensor) -> torch.Tensor:
    """y = gamma * (x - mean) / sqrt(var + eps) + beta over channel dim 1."""
    scale = bn.gamma / torch.sqrt(bn.variance + BN_EPS)
    offset = bn.beta - bn.mean * scale
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.to(x.dtype).view(shape) + offset.to(x.dtype).view(shape)


def bn_relu(bn: FrozenBN, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(frozen_bn(bn, x))
