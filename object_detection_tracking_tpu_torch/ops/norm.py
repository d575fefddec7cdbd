"""Frozen and batch-statistics BatchNorm, and GroupNorm (port of
object_detection_tracking_tpu/ops/norm.py:26-63, :99-116).

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

``group_norm`` is the FPN's optional GroupNorm (``use_gn``, JAX
ops/norm.py:106-116): min(32, C) groups, float32 statistics (a two-pass
variance, as ``jnp.var``), the affine in float32, the result in the
input's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5
GN_EPS = 1e-5


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


class GroupNorm(nn.Module):
    """GroupNorm affine parameters ``gamma``/``beta`` (the JAX tree's
    ``init_gn``); applied with ``group_norm``."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c), requires_grad=False)
        self.beta = nn.Parameter(torch.zeros(c), requires_grad=False)


def group_norm(gn: GroupNorm, x: torch.Tensor, groups: int = 32
               ) -> torch.Tensor:
    """GroupNorm over the channels (dim 1) of an NCHW map, computed on its
    NHWC view as JAX does, so a channels_last input gives a channels_last
    output."""
    n, c, h, w = x.shape
    g = min(groups, c)
    x32 = x.permute(0, 2, 3, 1).float().reshape(n, h, w, g, c // g)
    mean = x32.mean(dim=(1, 2, 4), keepdim=True)
    var = x32.var(dim=(1, 2, 4), unbiased=False, keepdim=True)
    x32 = ((x32 - mean) / torch.sqrt(var + GN_EPS)).reshape(n, h, w, c)
    return (x32 * gn.gamma + gn.beta).to(x.dtype).permute(0, 3, 1, 2)
