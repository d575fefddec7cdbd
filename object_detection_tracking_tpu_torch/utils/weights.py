"""Checkpoint conversion: the reference's TF/tensorpack weights and the
native flat npz -> the JAX-layout param tree (the port of
object_detection_tracking_tpu/utils/weights.py, numpy only).

``load_weights`` reads every format the JAX package's does, and returns a
nested dict of numpy float32 arrays in the JAX layout; load it into the
model with ``params.params_from_jax``:

  * a TF V2 checkpoint (a directory with a ``checkpoint`` state file, a
    prefix, or its ``.index`` path), read by utils/tf_ckpt.py;
  * an ``.npz`` of tensorpack/TF variable names (``group0/.../W:0``, BN
    statistics as ``.../bn/mean/EMA:0``);
  * the native flat slash-named ``.npz`` (``params.save_npz_tree``);
  * for EfficientDet, automl-named ``.npz`` files and bundles
    (utils/effdet_weights.py).

Every route starts from the port's ``params.init_params(cfg, seed=0)`` and
lays the checkpoint's leaves over it, as JAX's starts from its model's
``init_params(PRNGKey(0))``: a leaf the checkpoint lacks keeps that init,
whose keys and shapes are JAX's and whose values are not. The native npz
is strict: an unknown name raises ``KeyError``, a wrong shape
``ValueError``. The TF routes report unknown names and skip optimizer
slots and ``global_step``.

Layout notes:
  * conv kernels are HWIO in both stacks: no transpose;
  * the activations are NHWC while the reference ran NCHW; the only
    layout-sensitive weights are dense layers on flattened conv maps:
    fc6 rows are permuted (C,7,7) -> (7,7,C);
  * BN: gamma/beta/mean/EMA/variance/EMA -> gamma/beta/mean/variance.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from .effdet_weights import has_automl_names, load_effdet_reference
from .tf_ckpt import load_tf_checkpoint

Tree = Dict[str, object]

_OPTIMIZER_SLOTS = ("Adam", "Adam_1", "Momentum", "Adadelta", "Adadelta_1",
                    "beta1_power", "beta2_power")


def _set_path(tree: Tree, path, value, strict: bool = True) -> bool:
    node = tree
    for k in path[:-1]:
        if not isinstance(node, dict) or k not in node:
            if strict:
                raise KeyError("/".join(path))
            return False
        node = node[k]
    k = path[-1]
    if not isinstance(node, dict) or k not in node:
        if strict:
            raise KeyError("/".join(path))
        return False
    old = node[k]
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {'/'.join(path)}: "
            f"{tuple(old.shape)} vs {tuple(value.shape)}")
    node[k] = value.astype(np.float32)
    return True


def _map_tf_name(name: str) -> Tuple[Tuple[str, ...], str]:
    """TF variable name -> (path in the tree, kind).

    kind is "plain" or "fc6" (needs C-major -> HWC-major row permutation).
    """
    parts = name.split(":")[0].split("/")
    # BN stats: .../bn/mean/EMA -> .../bn/mean
    if len(parts) >= 3 and parts[-1] == "EMA":
        parts = parts[:-2] + [parts[-2]]
    top = parts[0]
    if top in ("fpn", "rpn", "maskrcnn"):
        return tuple(parts), "plain"
    if top == "fastrcnn":
        kind = "fc6" if (len(parts) >= 2 and parts[1] == "fc6"
                         and parts[-1] == "W") else "plain"
        return tuple(parts), kind
    # backbone names live at root scope in the reference (conv0, group0..)
    return tuple(["resnet"] + parts), "plain"


def _permute_fc6_rows(w: np.ndarray, feat_dim: int = 256,
                      pool: int = 7) -> np.ndarray:
    """[(C*7*7), D] C-major rows -> [(7*7*C), D] HWC-major rows."""
    d = w.shape[1]
    w = w.reshape(feat_dim, pool, pool, d)
    w = np.transpose(w, (1, 2, 0, 3))
    return w.reshape(pool * pool * feat_dim, d)


def _is_efficientdet(model) -> bool:
    return hasattr(model, "fpn_repeats") and hasattr(model, "backbone_name")


def _init_tree(model) -> Tree:
    """The tree every route starts from: the port's seeded init for
    ``model``'s configuration."""
    from ..params import init_params
    if _is_efficientdet(model):
        import dataclasses
        return init_params(
            dataclasses.replace(model.config, efficientdet_name=model.name),
            seed=0, model_name="efficientdet")
    return init_params(model.config, seed=0)


def load_reference_npz(path: str, model) -> Tree:
    """Load a tensorpack/TF-named .npz into the model's param tree."""
    with np.load(path) as data:
        return load_reference_dict(dict(data), model, source=path)


def load_reference_dict(weights: Dict[str, np.ndarray], model,
                        source: str = "<dict>") -> Tree:
    """Load a dict of TF-named arrays into the model's param tree.

    Unknown keys are reported; missing model params keep their init
    (the reference's partial restore)."""
    params = _init_tree(model)
    loaded, skipped = [], []
    for name, value in weights.items():
        base = name.split(":")[0]
        if "global_step" in base or base.split("/")[-1] in _OPTIMIZER_SLOTS:
            continue
        path_t, kind = _map_tf_name(name)
        if kind == "fc6":
            value = _permute_fc6_rows(value, model.config.fpn_num_channel, 7)
        try:
            ok = _set_path(params, path_t, value, strict=False)
        except ValueError as e:
            raise ValueError(f"converting {name}: {e}") from None
        (loaded if ok else skipped).append(name)
    if skipped:
        print(f"warning: {len(skipped)}/{len(weights)} arrays not "
              f"mapped: {sorted(skipped)[:8]}...")
    print(f"loaded {len(loaded)} arrays from {source}")
    return params


def load_npz(path: str, model, ignore_vars: str = None) -> Tree:
    """Load the native flat slash-named npz, strictly: every name must be
    a leaf of the model's tree, with its shape."""
    with np.load(path) as data:
        return _load_native(_filter_ignored(dict(data), ignore_vars), model)


def _load_native(weights: Dict[str, np.ndarray], model) -> Tree:
    params = _init_tree(model)
    for name, value in weights.items():
        _set_path(params, tuple(name.split("/")), value, strict=True)
    return params


def _filter_ignored(weights: Dict[str, np.ndarray], ignore_vars):
    """Drop tensors whose name contains any ':'-separated substring
    (reference --ignore_vars, models.py:3507-3525); dropped params keep
    their init: the fine-tune-with-new-heads workflow."""
    if not ignore_vars:
        return weights
    subs = [s for s in ignore_vars.split(":") if s]
    kept = {}
    for k, v in weights.items():
        if any(sub in k for sub in subs):
            print(f"ignored {k}")
        else:
            kept[k] = v
    return kept


def load_weights(path: str, model, ignore_vars: str = None) -> Tree:
    """Dispatch on the checkpoint's format (reference initialize,
    models.py:3489-3595; automl EfficientDet checkpoints as in
    efficientdet_wrapper.py). ``ignore_vars``: ':'-separated name
    substrings excluded from the restore."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            keys = data.files
            weights = _filter_ignored(dict(data), ignore_vars)
        if _is_efficientdet(model) and has_automl_names(keys):
            return load_effdet_reference(weights, model, source=path)
        if any(k.endswith(":0") or k.startswith(
                ("group0/", "conv0/", "fpn/", "rpn/", "fastrcnn/"))
               and "resnet/" not in k for k in keys[:50]):
            # TF-named checkpoint unless it already uses the "resnet/" root
            if not any(k.startswith("resnet/") for k in keys):
                return load_reference_dict(weights, model, source=path)
        return _load_native(weights, model)
    # TF V2 checkpoint: a prefix/.index path or a directory with a
    # 'checkpoint' state file, read TF-free by the tensor-bundle parser
    if (os.path.isdir(path) or path.endswith(".index") or
            os.path.exists(path + ".index")):
        tensors = _filter_ignored(load_tf_checkpoint(path), ignore_vars)
        if _is_efficientdet(model):
            return load_effdet_reference(tensors, model, source=path)
        return load_reference_dict(tensors, model, source=path)
    raise ValueError(f"unsupported checkpoint format: {path} "
                     "(expected .npz, a TF ckpt prefix/.index, or a ckpt "
                     "directory)")
