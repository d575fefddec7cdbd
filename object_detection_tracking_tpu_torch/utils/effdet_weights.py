"""EfficientDet checkpoint conversion: automl TF names -> our pytree (the
port's copy of object_detection_tracking_tpu/utils/effdet_weights.py,
numpy only; the name map is the same, tests/test_torch_isolation.py holds
it equal).

The published EfficientDet zoo (reference efficientdet_wrapper.py loads it
via tf.train.Saver) stores variables under the google/automl scopes:

  efficientnet-bX/stem|blocks_K/...      (efficientnet_model.py)
  resample_p6/...                        (efficientdet_arch.py:149)
  fpn_cells/cell_R/fnodeN/WSM[_i]        (efficientdet_arch.py:605-646)
  fpn_cells/cell_R/fnodeN/resample_I_O_M/...
  fpn_cells/cell_R/fnodeN/op_after_combineM/conv|bn/...
  class_net/class-I[-bn-L]/..., box_net/box-I[-bn-L]/...

Our BiFPN is weight-isomorphic with that graph (per-fnode lazy channel
resamples, see models/efficientdet/efficientdet.py), so conversion is a
renaming plus two layout fixes: depthwise kernels [H, W, C, 1] ->
[H, W, 1, C], and per-edge scalar WSM variables gathered into our [E]
fusion-weight vectors. utils/weights.py load_weights routes automl-named
``.npz`` files and TF bundles (read by utils/tf_ckpt.py) here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_BN = (("gamma", "gamma"), ("beta", "beta"),
       ("moving_mean", "mean"), ("moving_variance", "variance"))


def effdet_name_map(model) -> Dict[str, Tuple[Tuple[str, ...], object]]:
    """TF variable name (without :0) -> (our pytree path, kind).

    kind: "plain" | "dw" (depthwise kernel transpose) | ("wsm", i)
    (scalar edge weight -> element i of our wsm vector)."""
    from ..models.efficientdet.efficientdet import BIFPN_NODES
    from ..models.efficientdet.efficientnet import scaled_block_args

    m: Dict[str, Tuple[Tuple[str, ...], object]] = {}
    bb = model.backbone_name

    def bn(tf_scope, path):
        for tf_key, our_key in _BN:
            m[f"{tf_scope}/{tf_key}"] = (tuple(path) + (our_key,), "plain")

    # ---- EfficientNet backbone (efficientnet_model.py variable order:
    # expand conv2d -> bn, depthwise -> bn_1, project conv2d_1 -> bn_2;
    # expand-ratio-1 blocks skip the expand stage so numbering shifts)
    m[f"{bb}/stem/conv2d/kernel"] = (("backbone", "stem", "W"), "plain")
    bn(f"{bb}/stem/tpu_batch_normalization", ("backbone", "stem", "bn"))
    k = 0
    for gi, (_kz, _s, e, _i, _o, r) in enumerate(scaled_block_args(bb)):
        for bi in range(r):
            tfb = f"{bb}/blocks_{k}"
            path = ("backbone", f"group{gi}", f"block{bi}")
            if e != 1:
                m[f"{tfb}/conv2d/kernel"] = (path + ("expand", "W"),
                                             "plain")
                bn(f"{tfb}/tpu_batch_normalization", path + ("expand", "bn"))
                m[f"{tfb}/depthwise_conv2d/depthwise_kernel"] = (
                    path + ("dw", "W"), "dw")
                bn(f"{tfb}/tpu_batch_normalization_1", path + ("dw", "bn"))
                m[f"{tfb}/conv2d_1/kernel"] = (path + ("project", "W"),
                                               "plain")
                bn(f"{tfb}/tpu_batch_normalization_2",
                   path + ("project", "bn"))
            else:
                m[f"{tfb}/depthwise_conv2d/depthwise_kernel"] = (
                    path + ("dw", "W"), "dw")
                bn(f"{tfb}/tpu_batch_normalization", path + ("dw", "bn"))
                m[f"{tfb}/conv2d/kernel"] = (path + ("project", "W"),
                                             "plain")
                bn(f"{tfb}/tpu_batch_normalization_1",
                   path + ("project", "bn"))
            m[f"{tfb}/se/conv2d/kernel"] = (path + ("se_reduce", "W"),
                                            "plain")
            m[f"{tfb}/se/conv2d/bias"] = (path + ("se_reduce", "b"),
                                          "plain")
            m[f"{tfb}/se/conv2d_1/kernel"] = (path + ("se_expand", "W"),
                                              "plain")
            m[f"{tfb}/se/conv2d_1/bias"] = (path + ("se_expand", "b"),
                                            "plain")
            k += 1

    # ---- P6 input resample
    m["resample_p6/conv2d/kernel"] = (("resample", "p6", "W"), "plain")
    m["resample_p6/conv2d/bias"] = (("resample", "p6", "b"), "plain")
    bn("resample_p6/bn", ("resample", "p6", "bn"))

    # ---- BiFPN cells
    for rep in range(model.fpn_repeats):
        for ni, (_lvl, inputs) in enumerate(BIFPN_NODES):
            base = f"fpn_cells/cell_{rep}/fnode{ni}"
            path = ("fpn_cells", f"cell_{rep}", f"fnode{ni}")
            if model.fusion == "fastattn":
                for idx in range(len(inputs)):
                    nm = "WSM" if idx == 0 else f"WSM_{idx}"
                    m[f"{base}/{nm}"] = (path + ("wsm",), ("wsm", idx))
            if rep == 0:
                for idx, off in enumerate(inputs):
                    if off in (0, 1, 2):   # raw backbone channel inputs
                        rkey = f"resample_{idx}_{off}_{5 + ni}"
                        m[f"{base}/{rkey}/conv2d/kernel"] = (
                            path + (rkey, "W"), "plain")
                        m[f"{base}/{rkey}/conv2d/bias"] = (
                            path + (rkey, "b"), "plain")
                        bn(f"{base}/{rkey}/bn", path + (rkey, "bn"))
            oac = f"{base}/op_after_combine{5 + ni}"
            m[f"{oac}/conv/depthwise_kernel"] = (path + ("dw", "W"), "dw")
            m[f"{oac}/conv/pointwise_kernel"] = (path + ("pw", "W"),
                                                 "plain")
            m[f"{oac}/conv/bias"] = (path + ("pw", "b"), "plain")
            bn(f"{oac}/bn", path + ("bn",))

    # ---- class / box nets (shared convs, per-level bn)
    for net, stem in (("class_net", "class"), ("box_net", "box")):
        for i in range(model.head_repeats):
            base = f"{net}/{stem}-{i}"
            m[f"{base}/depthwise_kernel"] = ((net, f"conv{i}", "dw", "W"),
                                             "dw")
            m[f"{base}/pointwise_kernel"] = ((net, f"conv{i}", "pw", "W"),
                                             "plain")
            m[f"{base}/bias"] = ((net, f"conv{i}", "pw", "b"), "plain")
            for lvl in range(3, 8):
                bn(f"{net}/{stem}-{i}-bn-{lvl}", (net, f"bn{i}_l{lvl}"))
        m[f"{net}/{stem}-predict/depthwise_kernel"] = (
            (net, "predict", "dw", "W"), "dw")
        m[f"{net}/{stem}-predict/pointwise_kernel"] = (
            (net, "predict", "pw", "W"), "plain")
        m[f"{net}/{stem}-predict/bias"] = ((net, "predict", "pw", "b"),
                                           "plain")
    return m


def has_automl_names(names) -> bool:
    """Whether checkpoint array names are automl's (JAX
    utils/weights.py:191-197 looks at the first 80)."""
    return any(n.split(":")[0].startswith(
        ("efficientnet-", "fpn_cells/", "resample_p6/"))
        for n in list(names)[:80])


def load_effdet_reference(weights: Dict[str, np.ndarray], model,
                          source: str = "<dict>") -> Dict:
    """Load a dict of automl-named arrays into an EfficientDet param tree
    (nested dicts of numpy float32, the JAX layout; load it into the
    model with params.params_from_jax).

    Unmapped checkpoint arrays are reported (optimizer slots and the
    efficientnet classification head are expected leftovers); model params
    not present keep their random init (params.init_params, seed 0)."""
    from .weights import _init_tree

    params = _init_tree(model)
    name_map = effdet_name_map(model)

    def set_path(path, value):
        node = params
        for key in path[:-1]:
            node = node[key]
        old = node[path[-1]]
        if tuple(np.shape(old)) != tuple(value.shape):
            raise ValueError(
                f"shape mismatch at {'/'.join(path)}: "
                f"{tuple(np.shape(old))} vs {tuple(value.shape)}")
        node[path[-1]] = value.astype(np.float32)

    loaded, skipped = [], []
    for name, value in weights.items():
        base = name.split(":")[0]
        if base not in name_map:
            if not base.endswith(("/Momentum", "/RMSProp", "/RMSProp_1",
                                  "ExponentialMovingAverage")) and \
                    "global_step" not in base:
                skipped.append(base)
            continue
        path, kind = name_map[base]
        value = np.asarray(value)
        if kind == "dw":
            value = value.transpose(0, 1, 3, 2)   # [H,W,C,1] -> [H,W,1,C]
        if isinstance(kind, tuple) and kind[0] == "wsm":
            node = params
            for key in path[:-1]:
                node = node[key]
            vec = np.asarray(node[path[-1]]).copy()
            vec[kind[1]] = float(value)
            node[path[-1]] = vec
        else:
            set_path(path, value)
        loaded.append(base)

    if skipped:
        print(f"warning: {len(skipped)} ckpt arrays not mapped "
              f"(first: {sorted(skipped)[:6]})")
    print(f"loaded {len(loaded)} arrays from {source}")
    return params
