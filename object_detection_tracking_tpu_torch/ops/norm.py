"""Frozen and batch-statistics BatchNorm (port of
object_detection_tracking_tpu/ops/norm.py:26-63).

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

``batch_bn`` is the training-mode BN that EfficientDet trains with (JAX
ops/norm.py:41-63): the current batch's statistics in place of the stored
ones, differentiated through.
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


def batch_stats(x: torch.Tensor):
    """Per-channel float32 (mean, variance) of ``x`` over every dim but 1,
    as JAX computes them: E[x^2] - mean^2, not a two-pass variance."""
    dims = (0,) + tuple(range(2, x.dim()))
    xf = x.float()
    mu = xf.mean(dims)
    return mu, xf.square().mean(dims) - mu.square()


def batch_bn(bn: FrozenBN, x: torch.Tensor) -> torch.Tensor:
    """Training-mode BN: normalise with the batch's own statistics
    (``batch_stats``), then gamma/beta. The scale and offset fold in f32
    and apply in ``x``'s dtype, as ``frozen_bn``'s do; the gradient flows
    through the statistics. ``bn``'s stored mean and variance are not
    read (``EfficientDet.calibrate_bn`` writes them after training)."""
    mu, var = batch_stats(x)
    scale = bn.gamma / torch.sqrt(var + BN_EPS)
    offset = bn.beta - mu * scale
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return x * scale.to(x.dtype).view(shape) + offset.to(x.dtype).view(shape)
