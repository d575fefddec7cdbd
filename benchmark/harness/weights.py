"""Seeded weights: one flat tree (state name -> float32 tensor) that the
benchmark hands both to the program and to the reference.

The draws follow the initialiser families of the detector's own random
init (variance-scaling truncated normals, corrected for the truncation,
for the backbone, FPN, fc6/fc7 and mask head; plain normals for the RPN and
the output layers; zero biases; identity BN statistics), made on the
device from a ``torch.Generator`` in two large calls: one buffer of
truncated unit normals and one of unit normals, sliced and scaled leaf by
leaf. A configuration's ``weights`` section adds its adjustments: each
residual branch's last BN gamma scaled (``last_bn_gamma_scale``), named
leaves scaled (``leaf_scale``) and biases added to chosen class logits
(``class_logit_bias``).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

TRUNC_CORRECTION = 0.87962566103423978   # std of N(0, 1) cut at +-2


def family(name: str, shape: Tuple[int, ...]):
    """(kind, std) of one leaf: kind "trunc" (std before the correction),
    "normal", "zero", "one"."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("gamma", "variance"):
        return "one", 0.0
    if leaf in ("beta", "mean", "bias"):
        return "zero", 0.0
    if leaf != "weight":
        raise ValueError(f"no initialiser for {name}")
    if len(shape) == 4:       # conv [O, I/groups, k, k]
        o, i, kh, kw = shape
        fan_in, fan_out = i * kh * kw, o * kh * kw
    else:                     # linear [out, in]
        fan_out, fan_in = shape
    if name.startswith("rpn."):
        return "normal", 0.01
    if name == "fastrcnn.outputs.class.weight":
        return "normal", 0.01
    if name == "fastrcnn.outputs.box.weight":
        return "normal", 0.001
    if name.startswith("resnet."):
        return "trunc", math.sqrt(2.0 / fan_in)
    if name.startswith("maskrcnn."):
        return "trunc", math.sqrt(2.0 / fan_out)
    if name.startswith(("fpn.", "fastrcnn.")):
        return "trunc", math.sqrt(1.0 / fan_in)
    raise ValueError(f"no initialiser for {name}")


def seeded_tree(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                device, adjust: dict) -> Dict[str, torch.Tensor]:
    """The tree of ``shapes`` (name, shape) drawn from ``seed`` on
    ``device``, with the configuration's ``adjust`` (its ``weights``)."""
    shapes = list(shapes)
    kinds = {n: family(n, s) for n, s in shapes}
    n_trunc = sum(math.prod(s) for n, s in shapes if kinds[n][0] == "trunc")
    n_norm = sum(math.prod(s) for n, s in shapes if kinds[n][0] == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    trunc = torch.empty(n_trunc, device=device)
    torch.nn.init.trunc_normal_(trunc, 0.0, 1.0, -2.0, 2.0, generator=gen)
    normal = torch.empty(n_norm, device=device).normal_(generator=gen)
    tree, at = {}, {"trunc": 0, "normal": 0}
    for name, shape in shapes:
        kind, std = kinds[name]
        size = math.prod(shape)
        if kind == "one":
            t = torch.ones(shape, device=device)
        elif kind == "zero":
            t = torch.zeros(shape, device=device)
        else:
            src = trunc if kind == "trunc" else normal
            scale = std / TRUNC_CORRECTION if kind == "trunc" else std
            t = src[at[kind]:at[kind] + size].view(shape) * scale
            at[kind] += size
        tree[name] = t
    gamma = adjust.get("last_bn_gamma_scale")
    if gamma is not None:
        for name in tree:
            if name.startswith("resnet.group") and name.endswith(
                    ".conv3.bn.gamma"):
                tree[name] = tree[name] * gamma
    for name, factor in adjust.get("leaf_scale", {}).items():
        tree[name] = tree[name] * factor
    for cls, bias in adjust.get("class_logit_bias", {}).items():
        tree["fastrcnn.outputs.class.bias"][int(cls)] += bias
    return tree


def load_into(model: torch.nn.Module, tree: Dict[str, torch.Tensor]):
    """Copy ``tree`` into ``model``'s parameters; every parameter must be in
    the tree, with its shape."""
    params = dict(model.named_parameters())
    if set(params) != set(tree):
        raise ValueError(f"tree and model differ: "
                         f"{sorted(set(params) ^ set(tree))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(tree[name])
    return model
