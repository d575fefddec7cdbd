"""Weights across the two packages.

The JAX package keeps parameters as a pytree of nested dicts with TF-scope
names (``resnet/group0/block0/conv1/W``, ``.../bn/gamma``), which is also
the flat slash-named layout of its native ``.npz`` (utils/weights.py
save_npz). The port's modules carry the same names, so a tree path maps to
a module attribute one to one:

  * ``Conv.weight`` [O, I, kh, kw]  <->  conv ``W`` HWIO [kh, kw, I, O]
  * ``nn.Linear.weight`` [out, in]  <->  dense ``W`` [in, out]
  * ``bias``                        <->  ``b``
  * FrozenBN parameters             <->  ``bn/{gamma,beta,mean,variance}``
  * any other module's own parameter (EfficientDet's BiFPN fusion weights
    ``wsm``)                         <->  the leaf of its name, as it is

A depthwise conv is a grouped ``Conv``: HWIO [k, k, 1, C] <-> [C, 1, k, k]
by the same transpose.

``init_params`` builds that tree without JAX, from a ``torch.Generator``,
with the JAX initialiser families (models/layers.py:29-61, fpn.py:20-74,
heads.py:20-57, :106-119, relation.py:21-38, resnet.py:94-100, ops/norm.py:
99-103, efficientdet/efficientnet.py:101-140,
efficientdet/efficientdet.py:93-163): the same distributions, not the
same bits.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .models.layers import Conv
from .ops.norm import FrozenBN

Tree = Dict[str, object]

_BN_NAMES = ("gamma", "beta", "mean", "variance")


def _leaves(model: nn.Module):
    """(tree path, tensor, kind) for every weight of ``model``."""
    for name, mod in model.named_modules():
        path = tuple(name.split(".")) if name else ()
        if isinstance(mod, (Conv, nn.Linear)):
            kind = "conv" if isinstance(mod, Conv) else "dense"
            yield path + ("W",), mod.weight, kind
            if mod.bias is not None:
                yield path + ("b",), mod.bias, "bias"
        elif isinstance(mod, FrozenBN):
            for n in _BN_NAMES:
                yield path + (n,), getattr(mod, n), "bn"
        else:
            for n, t in mod.named_parameters(recurse=False):
                yield path + (n,), t, "plain"


def native_names(model: nn.Module) -> Dict[str, Tuple[str, str]]:
    """For every weight of ``model``, its native npz name -> (its state
    name, its layout kind: "conv", "dense", "bias", "bn" or "plain")."""
    attrs = {"conv": {"W": "weight"}, "dense": {"W": "weight"},
             "bias": {"b": "bias"}}
    out = {}
    for path, _, kind in _leaves(model):
        attr = attrs.get(kind, {}).get(path[-1], path[-1])
        out["/".join(path)] = (".".join(path[:-1] + (attr,)), kind)
    return out


def _to_torch(value: np.ndarray, kind: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(value, np.float32))   # a writable copy
    if kind == "conv":
        return t.permute(3, 2, 0, 1)
    if kind == "dense":
        return t.t()
    return t


def _to_jax(t: torch.Tensor, kind: str) -> np.ndarray:
    t = t.detach().cpu()
    if kind == "conv":
        t = t.permute(2, 3, 1, 0)
    elif kind == "dense":
        t = t.t()
    return np.ascontiguousarray(t.numpy())


def _get(tree: Tree, path: Sequence[str]):
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            raise KeyError("/".join(path))
        node = node[k]
    return node


def params_from_jax(tree: Tree, model: nn.Module) -> nn.Module:
    """Load a JAX param tree (nested dicts of numpy arrays) into ``model``
    in place and return it. Every module weight must be in the tree with
    the matching shape."""
    with torch.no_grad():
        for path, dst, kind in _leaves(model):
            src = _to_torch(np.asarray(_get(tree, path)), kind)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                                 f"{tuple(src.shape)} vs {tuple(dst.shape)}")
            dst.copy_(src)
    return model


def params_to_jax(model: nn.Module) -> Tree:
    """The JAX param tree of ``model``'s weights (numpy float32)."""
    tree: Tree = {}
    for path, t, kind in _leaves(model):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _to_jax(t, kind)
    return tree


# the roots of the native trees by model name: Faster/Mask R-CNN (one
# model class), EfficientDet
_RCNN_ROOTS = ("resnet/", "fpn/", "rpn/", "fastrcnn/", "maskrcnn/",
               "small_objects/")
_NATIVE_ROOTS = {
    "faster_rcnn": _RCNN_ROOTS,
    "mask_rcnn": _RCNN_ROOTS,
    "efficientdet": ("backbone/", "resample/", "fpn_cells/", "class_net/",
                     "box_net/"),
}


def load_npz_tree(path: str, model_name: str = "faster_rcnn") -> Tree:
    """Nested param tree from the JAX package's native flat slash-named
    ``.npz`` (utils/weights.py:127-168), with numpy alone, exactly the
    names the file holds. A file of other names (tensorpack/TF or automl
    names, another model's roots) raises ``ValueError``: read such
    checkpoints with ``utils.weights.load_weights``, which also lays a
    native npz over the model's init, strictly."""
    out: Tree = {}
    with np.load(path) as data:
        for name in data.files:
            if name.endswith(":0") or not name.startswith(
                    _NATIVE_ROOTS[model_name]):
                raise ValueError(
                    f"{path}: {name!r} is not a name of the native flat "
                    f"npz layout of {model_name!r}; load tensorpack/TF and "
                    "automl checkpoints with utils.weights.load_weights")
            node = out
            parts = name.split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = data[name]
    return out


def save_npz_tree(path: str, tree: Tree) -> None:
    """Write a nested param tree as the JAX package's native flat
    slash-named ``.npz`` (utils/weights.py save_npz), with numpy alone:
    the JAX package's ``load_weights`` and the port's ``load_npz_tree``
    both read it."""
    flat = {}

    def rec(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, prefix + [k])
        else:
            flat["/".join(prefix)] = np.asarray(node)

    rec(tree, [])
    np.savez(path, **flat)


# --------------------------------------------------------------------------
# JAX-free init


def _bn_leaves(c: int) -> Tree:
    """JAX ops/norm.py init_bn: identity statistics."""
    return {"gamma": np.ones((c,), np.float32),
            "beta": np.zeros((c,), np.float32),
            "mean": np.zeros((c,), np.float32),
            "variance": np.ones((c,), np.float32)}


class _Init:
    """The JAX initialiser families over one torch.Generator (CPU, f32)."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(seed)

    def _variance_scaling(self, shape, scale: float, fan: int) -> np.ndarray:
        # jax.nn.initializers.variance_scaling(..., "truncated_normal"):
        # N(0, std) truncated to +-2 std, std corrected for the truncation
        std = math.sqrt(scale / fan) / .87962566103423978
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                    generator=self.gen)
        return t.numpy()

    def _normal(self, shape, stddev: float) -> np.ndarray:
        t = torch.empty(shape)
        torch.nn.init.normal_(t, 0.0, stddev, generator=self.gen)
        return t.numpy()

    def conv(self, kernel: int, c_in: int, c_out: int, use_bias: bool = True,
             w_init: str = "msra", stddev: float = 0.01, groups: int = 1,
             bn: bool = False) -> Tree:
        shape = (kernel, kernel, c_in // groups, c_out)
        receptive = kernel * kernel
        if w_init == "msra":
            w = self._variance_scaling(shape, 2.0, receptive * shape[2])
        elif w_init == "msra_fanout":
            w = self._variance_scaling(shape, 2.0, receptive * c_out)
        elif w_init == "xavier1":
            w = self._variance_scaling(shape, 1.0, receptive * shape[2])
        elif w_init == "normal":
            w = self._normal(shape, stddev)
        else:
            raise ValueError(w_init)
        p: Tree = {"W": w}
        if use_bias:
            p["b"] = np.zeros((c_out,), np.float32)
        if bn:
            p["bn"] = _bn_leaves(c_out)
        return p

    def dense(self, d_in: int, d_out: int, w_init: str = "xavier1",
              stddev: float = 0.01) -> Tree:
        if w_init == "xavier1":
            w = self._variance_scaling((d_in, d_out), 1.0, d_in)
        elif w_init == "msra":
            w = self._variance_scaling((d_in, d_out), 2.0, d_in)
        elif w_init == "normal":
            w = self._normal((d_in, d_out), stddev)
        else:
            raise ValueError(w_init)
        return {"W": w, "b": np.zeros((d_out,), np.float32)}


def _gn_leaves(c: int) -> Tree:
    """JAX ops/norm.py init_gn."""
    return {"gamma": np.ones((c,), np.float32),
            "beta": np.zeros((c,), np.float32)}


def _init_relation(init: _Init, feat_dim: int, group: int = 16,
                   geo_feat_dim: int = 64) -> Tree:
    """JAX relation.py init_relation: ``output_linear.W`` is
    [group * D, D]."""
    return {
        "geo_emb": init.dense(4, geo_feat_dim),
        "geo_conv": init.dense(geo_feat_dim, group),
        "query_linear": {"W": init.dense(feat_dim, feat_dim)["W"]},
        "key_linear": {"W": init.dense(feat_dim, feat_dim)["W"]},
        "output_linear": {"W": init.dense(group * feat_dim, feat_dim)["W"]},
    }


def _init_resnet(init: _Init, cfg, modified_block_num: int = 3) -> Tree:
    params: Tree = {"conv0": init.conv(7, 3, 64, use_bias=False, bn=True)}
    c_in = 64
    for gi, (count, feat) in enumerate(zip(cfg.resnet_num_block,
                                           (64, 128, 256, 512))):
        group: Tree = {}
        for bi in range(count):
            if cfg.use_basic_block:
                p = {"conv1": init.conv(3, c_in, feat, False, bn=True),
                     "conv2": init.conv(3, feat, feat, False, bn=True)}
                if c_in != feat:
                    p["convshortcut"] = init.conv(1, c_in, feat, False,
                                                  bn=True)
                c_in = feat
            else:
                width = feat * 2 if cfg.use_resnext else feat
                groups = 32 if cfg.use_resnext else 1
                p = {"conv1": init.conv(1, c_in, width, False, bn=True),
                     "conv2": init.conv(3, width, width, False,
                                        groups=groups, bn=True),
                     "conv3": init.conv(1, width, feat * 4, False, bn=True)}
                if (cfg.use_deformable and gi >= 1
                        and bi >= count - modified_block_num):
                    p["conv2_offset"] = init.conv(3, width, 18,
                                                  w_init="normal",
                                                  stddev=1e-8)
                if c_in != feat * 4:
                    p["convshortcut"] = init.conv(1, c_in, feat * 4, False,
                                                  bn=True)
                if cfg.use_se:
                    p["fc1"] = init.dense(feat * 4, feat // 4)
                    p["fc2"] = init.dense(feat // 4, feat * 4)
                c_in = feat * 4
            group[f"block{bi}"] = p
        params[f"group{gi}"] = group
    return params


def init_params(config, seed: int = 0, model_name: str = "faster_rcnn"
                ) -> Tree:
    """JAX-layout param tree for ``get_model(config, model_name)``, drawn
    from a ``torch.Generator`` seeded with ``seed``."""
    cfg = config
    if model_name == "efficientdet":
        return _init_efficientdet(_Init(seed), cfg)
    init = _Init(seed)
    c_channels = ((64, 128, 256, 512) if cfg.use_basic_block
                  else (256, 512, 1024, 2048))
    ch = cfg.fpn_num_channel
    fpn: Tree = {}
    for i, c in enumerate(c_channels):
        fpn[f"lateral_1x1_c{i + 2}"] = init.conv(1, c, ch, w_init="xavier1")
        fpn[f"posthoc_3x3_p{i + 2}"] = init.conv(3, ch, ch, w_init="xavier1")
        if cfg.use_gn:
            fpn[f"gn_c{i + 2}"] = _gn_leaves(ch)
            fpn[f"gn_p{i + 2}"] = _gn_leaves(ch)
    a = cfg.num_anchors_per_cell
    rpn = {"conv0": init.conv(3, ch, ch, w_init="normal", stddev=0.01),
           "class": init.conv(1, ch, a, w_init="normal", stddev=0.01),
           "box": init.conv(1, ch, 4 * a, w_init="normal", stddev=0.01)}
    fc = cfg.fpn_frcnn_fc_head_dim
    n_box = 1 if cfg.use_frcnn_class_agnostic else cfg.num_class
    fastrcnn = {
        "outputs": {
            "class": init.dense(fc, cfg.num_class, "normal", 0.01),
            "box": init.dense(fc, n_box * 4, "normal", 0.001),
        },
    }
    if cfg.use_conv_frcnn_head:     # JAX heads.py:38-45
        c_in, cd = ch, cfg.conv_frcnn_head_dim
        for k in range(4):
            fastrcnn[f"conv{k}"] = init.conv(3, c_in, cd,
                                             w_init="msra_fanout")
            c_in = cd
        fastrcnn["fc"] = init.dense(7 * 7 * cd, fc)
    else:
        fastrcnn["fc6"] = init.dense(7 * 7 * ch, fc)
        fastrcnn["fc7"] = init.dense(fc, fc)
    if cfg.add_relation_nn:
        fastrcnn["RM_r1"] = _init_relation(init, fc)
        fastrcnn["RM_r2"] = _init_relation(init, fc)
    if cfg.use_att_frcnn_head:
        fastrcnn["attention"] = init.conv(3, ch, 1, w_init="xavier1")
        fastrcnn["att_trans"] = init.dense(ch, fc)
    tree = {"resnet": _init_resnet(init, cfg), "fpn": fpn, "rpn": rpn,
            "fastrcnn": fastrcnn}
    if cfg.add_mask:   # JAX heads.py:106-119
        hd, mask, c_in = cfg.mrcnn_head_dim, {}, ch
        for k in range(4):
            mask[f"fcn{k}"] = init.conv(3, c_in, hd, w_init="msra_fanout")
            c_in = hd
        mask["deconv"] = init.conv(2, hd, hd, w_init="msra_fanout")
        mask["conv"] = init.conv(1, hd, cfg.num_class - 1,
                                 w_init="msra_fanout")
        tree["maskrcnn"] = mask
    if cfg.use_small_object_head:
        tree["small_objects"] = _init_small_objects(init, cfg)
    return tree


def _init_small_objects(init: _Init, cfg) -> Tree:
    """JAX faster_rcnn.py:109-123: a 2-way dense a small-object class, and
    the person relation with ``use_so_association``."""
    fc = cfg.fpn_frcnn_fc_head_dim
    so: Tree = {}
    names = [n for n in cfg.small_objects if n in cfg.classname2id]
    for i in range(len(names)):
        so[f"small_object_classification_c{i + 1}"] = init.dense(
            fc, 2, "normal", 0.01)
    if cfg.use_so_association:
        so["person_object_relation"] = _init_relation(init, fc)
    return so


def init_small_objects(config, seed: int = 0) -> Tree:
    """The ``small_objects`` subtree alone, drawn from its own generator
    seeded with ``seed``: the heads' leaves for a detector tree drawn
    without them."""
    return _init_small_objects(_Init(seed), config)


def _init_efficientnet(init: _Init, model_name: str) -> Tree:
    """JAX efficientnet.py init_efficientnet (:117-140)."""
    from .models.efficientdet.efficientnet import (SE_RATIO, is_lite,
                                                   scaled_block_args,
                                                   stem_channels)
    cin = stem_channels(model_name)
    params: Tree = {"stem": init.conv(3, 3, cin, False, "msra_fanout",
                                      bn=True)}
    use_se = not is_lite(model_name)
    for gi, (k, _s, e, _i, o, r) in enumerate(scaled_block_args(model_name)):
        group: Tree = {}
        for bi in range(r):
            c_in = cin if bi == 0 else o
            mid = c_in * e
            p: Tree = {}
            if e != 1:
                p["expand"] = init.conv(1, c_in, mid, False, "msra_fanout",
                                        bn=True)
            p["dw"] = init.conv(k, mid, mid, False, "msra_fanout",
                                groups=mid, bn=True)
            if use_se:
                se_ch = max(1, int(c_in * SE_RATIO))
                p["se_reduce"] = init.conv(1, mid, se_ch, w_init="msra")
                p["se_expand"] = init.conv(1, se_ch, mid, w_init="msra")
            p["project"] = init.conv(1, mid, o, False, "msra_fanout",
                                     bn=True)
            group[f"block{bi}"] = p
        cin = o
        params[f"group{gi}"] = group
    return params


def _init_efficientdet(init: _Init, cfg) -> Tree:
    """JAX EfficientDet.init_params (efficientdet.py:93-163)."""
    from .models.efficientdet.efficientdet import (BIFPN_NODES,
                                                   EFFICIENTDET_CONFIGS,
                                                   MAX_LEVEL, MIN_LEVEL,
                                                   NUM_ANCHORS,
                                                   backbone_channels)
    (backbone, _size, c, fpn_repeats, head_repeats, fusion,
     _scale) = EFFICIENTDET_CONFIGS[cfg.efficientdet_name]

    def sep_conv(cin, cout):
        return {"dw": init.conv(3, cin, cin, False, "xavier1", groups=cin),
                "pw": init.conv(1, cin, cout, True, "xavier1")}

    c3, c4, c5 = backbone_channels(backbone)
    raw_ch = {0: c3, 1: c4, 2: c5}
    tree: Tree = {
        "backbone": _init_efficientnet(init, backbone),
        "resample": {"p6": init.conv(1, c5, c, True, "xavier1", bn=True)}}
    cells: Tree = {}
    for rep in range(fpn_repeats):
        cell: Tree = {}
        for ni, (_lvl, inputs) in enumerate(BIFPN_NODES):
            node = sep_conv(c, c)
            node["bn"] = _bn_leaves(c)
            if fusion == "fastattn":
                node["wsm"] = np.ones((len(inputs),), np.float32)
            if rep == 0:
                for idx, off in enumerate(inputs):
                    if off in raw_ch:
                        node[f"resample_{idx}_{off}_{5 + ni}"] = init.conv(
                            1, raw_ch[off], c, True, "xavier1", bn=True)
            cell[f"fnode{ni}"] = node
        cells[f"cell_{rep}"] = cell
    tree["fpn_cells"] = cells

    def head(out_ch, bias):
        layers: Tree = {}
        for i in range(head_repeats):
            layers[f"conv{i}"] = sep_conv(c, c)
            for lvl in range(MIN_LEVEL, MAX_LEVEL + 1):
                layers[f"bn{i}_l{lvl}"] = _bn_leaves(c)
        layers["predict"] = sep_conv(c, out_ch)
        layers["predict"]["pw"]["b"] = np.full((out_ch,), bias, np.float32)
        return layers

    n_cls = cfg.num_class - 1
    tree["class_net"] = head(n_cls * NUM_ANCHORS,
                             -math.log((1 - 0.01) / 0.01))
    tree["box_net"] = head(4 * NUM_ANCHORS, 0.0)
    return tree
