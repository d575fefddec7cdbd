"""Shared pieces of the ReID nets (port of
object_detection_tracking_tpu/models/reid/common.py:11-45).

The JAX package applies its convs, BNs and pools as functions over a flat
dict keyed by torchreid's state_dict names. Here they are the nn.Modules
torchreid builds, under the same names, so a torchreid ``.pth`` loads with
``load_state_dict(strict=True)``. The nets take NCHW images (channels_last
memory in the extractor) and return float32 features [B, D].
"""

from __future__ import annotations

import torch
from torch import nn


class ReIDNet(nn.Module):
    """Base of the ReID nets. ``cast`` puts a net in its compute dtype,
    keeping the submodules named in ``f32_modules`` in float32 (OSNet's fc
    head, which the JAX forward runs in float32)."""

    f32_modules: tuple = ()
    feature_dim: int = 0

    def cast(self, dtype: torch.dtype) -> "ReIDNet":
        self.to(dtype)
        for name in self.f32_modules:
            getattr(self, name).float()
        return self


def fc_head(input_dim: int, dim: int) -> nn.Sequential:
    """torchreid's ``_construct_fc_layer`` with one fc dim and no dropout:
    ``fc.0`` Linear, ``fc.1`` BN1d, ReLU."""
    return nn.Sequential(nn.Linear(input_dim, dim), nn.BatchNorm1d(dim),
                         nn.ReLU(inplace=True))


def init_params(net: nn.Module):
    """torchreid's ``_init_params`` (the same in osnet.py, osnet_ain.py and
    resnet.py): kaiming-normal convs (fan_out), unit BN and IN affines,
    N(0, 0.01) linears, zero biases."""
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu")
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm1d,
                            nn.InstanceNorm2d)) and m.affine:
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Linear):
            nn.init.normal_(m.weight, 0, 0.01)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
