"""Shared pieces of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py): small configurations, seeded params, the
float32 comparison rule."""

import numpy as np

from object_detection_tracking_tpu.config import DetectorConfig

H, W = 64, 96
SMALL = dict(short_edge_size=H, max_size=W, rpn_test_post_nms_topk=32,
             result_per_im=8, compute_dtype="float32", rpn_topk_recall=1.0,
             roi_align_impl="xla")
CONFIGS = {
    "r18": lambda: DetectorConfig(num_class=5, resnet_depth=18, **SMALL),
    "r50_partial_coco": lambda: DetectorConfig.coco_partial(
        resnet_depth=50, **SMALL),
    "r50_v4": lambda: DetectorConfig.from_version(
        4, num_class=5, resnet_depth=50, **SMALL),
}


def jax_params(jm, seed=0):
    """JAX init_params as numpy, with each residual branch's last BN gamma
    scaled by 0.2. Random ResNet weights otherwise grow activations to
    ~1e3 by p2, every RPN box decodes off the image, and no proposal
    survives: the comparison would only see empty outputs."""
    import jax
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    for gname, group in params["resnet"].items():
        if gname.startswith("group"):
            for blk in group.values():
                last = blk["conv3"] if "conv3" in blk else blk["conv2"]
                last["bn"]["gamma"] = last["bn"]["gamma"] * 0.2
    return params


def close(got, ref, rel=1e-4):
    """float32 agreement up to ``rel`` of the reference's largest
    magnitude (differently ordered sums round differently)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-6))


def compare_forward(cfg, params, imgs):
    """The port's forward against the eager JAX forward on the same params
    and uint8 frames: valid slots and labels equal, boxes to 1e-3 px,
    probabilities to 1e-5, embeddings to 1e-4 of their largest magnitude,
    invalid slots 0. Returns (port outputs, JAX outputs) as numpy."""
    import torch

    from object_detection_tracking_tpu.models import get_model as jax_model
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import params_from_jax
    tm = params_from_jax(params, get_model(cfg))
    ref = {k: np.asarray(v)
           for k, v in jax_model(cfg).forward(params, imgs).items()}
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in tm(torch.from_numpy(imgs)).items()}
    assert set(got) == set(ref)
    valid = ref["final_valid"]
    assert valid.any()
    np.testing.assert_array_equal(got["final_valid"], valid)
    np.testing.assert_array_equal(got["final_labels"], ref["final_labels"])
    np.testing.assert_allclose(got["final_boxes"], ref["final_boxes"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["final_probs"], ref["final_probs"],
                               atol=1e-5, rtol=0)
    close(got["pooled_box_feat"], ref["pooled_box_feat"])
    close(got["fpn_box_feat"], ref["fpn_box_feat"])
    assert not got["fpn_box_feat"][~valid].any()
    return got, ref


# --------------------------------------------------------------------------
# training


TRAIN = dict(num_class=4, resnet_depth=18, short_edge_size=48, max_size=64,
             rpn_train_pre_nms_topk=32, rpn_train_post_nms_topk=32,
             rpn_batch_per_im=32, fastrcnn_batch_per_im=16, result_per_im=5,
             compute_dtype="float32", is_train=True, rpn_topk_recall=1.0,
             roi_align_impl="xla")


def train_configs(**overrides):
    """(JAX config, port config) of the small training setup: JAX with
    the exact XLA ROIAlign, the port with the train CLI's trainable ROIAlign
    (its plain version on the CPU)."""
    import dataclasses

    from object_detection_tracking_tpu_torch.config import \
        DetectorConfig as PortConfig
    jcfg = DetectorConfig(**{**TRAIN, **overrides})
    tcfg = PortConfig(**{**dataclasses.asdict(jcfg),
                         "roi_align_impl": "pallas",
                         "roi_align_train_impl": "pallas"})
    return jcfg, tcfg


def train_batch(b=2, g=4, h=48, w=64, num_class=4, seed=0, masks=False):
    """tests/test_train.py's batch (one padded gt row), with box-local disc
    masks when asked: (images, gt_boxes, gt_labels, gt_valid, gt_masks)."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (b, h, w, 3)).astype(np.uint8)
    xy = rng.uniform(0, 30, (b, g, 2)).astype(np.float32)
    wh = rng.uniform(6, 16, (b, g, 2)).astype(np.float32)
    gt_boxes = np.concatenate([xy, xy + wh], axis=-1)
    gt_labels = rng.randint(1, num_class, (b, g)).astype(np.int32)
    gt_valid = np.ones((b, g), bool)
    gt_valid[-1, -1] = False
    gt_masks = None
    if masks:
        ms = 28
        yy, xx = np.mgrid[0:ms, 0:ms]
        disc = (((yy - ms / 2) ** 2 + (xx - ms / 2) ** 2)
                < (ms / 2.5) ** 2).astype(np.float32)
        gt_masks = np.broadcast_to(disc, (b, g, ms, ms)).copy()
    return images, gt_boxes, gt_labels, gt_valid, gt_masks


def jax_draws(keys, n):
    """The uniform draws of JAX's target sampling for per-image ``keys``:
    each key splits into (fg, bg) and each draws U[0, 1) of shape (n,)
    (train/targets.py:76-81, :118-121). Returns torch [len(keys), n] x2."""
    import jax
    import torch
    fg, bg = [], []
    for k in keys:
        kf, kb = jax.random.split(k)
        fg.append(np.asarray(jax.random.uniform(kf, (n,))))
        bg.append(np.asarray(jax.random.uniform(kb, (n,))))
    return torch.from_numpy(np.stack(fg)), torch.from_numpy(np.stack(bg))


def forward_train_noise(jm, rng, b, h, w, n_props, g):
    """JAX forward_train's draws for key ``rng`` (faster_rcnn.py:713:
    split into 2B keys, RPN first), as the port's ``noise`` dict."""
    import jax
    _, _, fields, _ = jm._static_geometry(h, w)
    na = sum(np.asarray(f).reshape(-1, 4).shape[0] for f in fields)
    keys = jax.random.split(rng, 2 * b)
    rf, rb = jax_draws(keys[:b], na)
    ff, fb = jax_draws(keys[b:], n_props + g)
    return {"rpn_fg": rf, "rpn_bg": rb, "frcnn_fg": ff, "frcnn_bg": fb}


def grad_tree(model):
    """The JAX tree of ``model``'s parameter gradients (zeros where none)."""
    from object_detection_tracking_tpu_torch.params import _leaves, _to_jax
    tree = {}
    for path, t, kind in _leaves(model):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (np.zeros(_to_jax(t, kind).shape, np.float32)
                          if t.grad is None else _to_jax(t.grad, kind))
    return tree


def flat(tree, prefix=""):
    """{"a/b/W": leaf} of a nested tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def train_setup(freeze, add_mask, key=3):
    """The small training case: (JAX model, JAX params, numpy batch, JAX
    key, the port's noise for that key, the port's model, torch batch)."""
    import jax
    import torch

    from object_detection_tracking_tpu.models import get_model as jax_model
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import params_from_jax
    jcfg, tcfg = train_configs(freeze=freeze, add_mask=add_mask)
    jm = jax_model(jcfg)
    params = jax_params(jm)
    batch = train_batch(masks=add_mask)
    rng = jax.random.PRNGKey(key)
    noise = forward_train_noise(jm, rng, 2, 48, 64,
                                jcfg.rpn_train_post_nms_topk, 4)
    tm = params_from_jax(params, get_model(tcfg))
    tbatch = [None if x is None else torch.from_numpy(x) for x in batch]
    return jm, params, batch, rng, noise, tm, tbatch
