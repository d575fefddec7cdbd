"""Shared pieces of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py): small configurations, seeded params, the
float32 comparison rule."""

import copy
import dataclasses
from functools import lru_cache

import numpy as np
import pytest

from object_detection_tracking_tpu.config import DetectorConfig

H, W = 64, 96


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch intra-op thread for the module that imports this fixture
    (an autouse fixture in its namespace). Torch's default, a thread a
    core, oversubscribes the cores when six tier-1 workers run at once:
    a file that takes 28 s alone took 205 s among them."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@lru_cache(maxsize=None)
def _init_tree(cfg):
    """The port's init_params tree for the JAX config ``cfg`` (cached; the
    callers copy it before changing it)."""
    from object_detection_tracking_tpu_torch.config import \
        DetectorConfig as PortConfig
    from object_detection_tracking_tpu_torch.params import init_params
    return init_params(PortConfig(**dataclasses.asdict(cfg)))


def option_tree(cfg):
    """One tree for both packages under the detector's architecture
    options, from the port's init (the JAX initialiser families drawn from
    a torch.Generator; JAX's own init takes ~7-15 s at R50 on the CPU):
    each residual branch's last BN gamma x0.2 (as ``jax_params``, for the
    reason given there), GroupNorm's gamma drawn from U(0.8, 1.2) and beta
    from N(0, 0.1) (off the identity, so that a swap would show), and each
    deformable offset conv redrawn so that its taps move by about a pixel
    (at the init's stddev of 1e-8 they would not move at all)."""
    tree = copy.deepcopy(_init_tree(cfg))
    rng = np.random.RandomState(1)
    for gname, group in tree["resnet"].items():
        if gname.startswith("group"):
            for blk in group.values():
                last = blk["conv3"] if "conv3" in blk else blk["conv2"]
                last["bn"]["gamma"] = last["bn"]["gamma"] * 0.2
                if "conv2_offset" in blk:
                    wo = blk["conv2_offset"]["W"]
                    std = 0.5 / np.sqrt(wo.shape[0] * wo.shape[1]
                                        * wo.shape[2])
                    blk["conv2_offset"]["W"] = (
                        rng.randn(*wo.shape) * std).astype(np.float32)
    for name, node in tree["fpn"].items():
        if name.startswith("gn_"):
            node["gamma"] = rng.uniform(0.8, 1.2, node["gamma"].shape
                                        ).astype(np.float32)
            node["beta"] = (0.1 * rng.randn(*node["beta"].shape)
                            ).astype(np.float32)
    return tree


def close(got, ref, rel=1e-4):
    """float32 agreement up to ``rel`` of the reference's largest
    magnitude (differently ordered sums round differently)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-6))


def compare_forward(cfg, params, imgs, ref_params=None, jit=False):
    """The port's forward against the eager JAX forward (jitted with
    ``jit``: a cold eager forward compiles op by op, ~30 s for R18 on the
    CPU; BGR frames only, see tests/test_torch_forward.py) on the same
    params (or on ``ref_params``, where given) and uint8 frames: valid
    slots and labels equal, boxes to 1e-3 px, probabilities to 1e-5,
    embeddings to 1e-4 of their largest magnitude, invalid slots 0.
    Returns (port outputs, JAX outputs) as numpy."""
    import jax
    import torch

    from object_detection_tracking_tpu.models import get_model as jax_model
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import params_from_jax
    tm = params_from_jax(params, get_model(cfg))
    forward = jax_model(cfg).forward
    if jit:
        forward = jax.jit(forward)
    ref = {k: np.asarray(v) for k, v in forward(
        params if ref_params is None else ref_params, imgs).items()}
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


# --------------------------------------------------------------------------
# EfficientDet


def port_config(jcfg, **overrides):
    """The port's DetectorConfig with the values of the JAX one."""
    import dataclasses

    from object_detection_tracking_tpu_torch.config import \
        DetectorConfig as PortConfig
    return PortConfig(**{**dataclasses.asdict(jcfg), **overrides})


def calibrating_bn(bn, x):
    """A BN that first sets its statistics from its NCHW input: every
    channel the mean and variance of the whole input (one pair per site,
    so that P7's 1x1 maps of a small batch give a stable variance), then
    applies them."""
    from object_detection_tracking_tpu_torch.ops.norm import frozen_bn
    bn.mean.fill_(x.mean().item())
    bn.variance.fill_(x.var(unbiased=False).item())
    return frozen_bn(bn, x)


def effdet_params(jcfg, images, seed=0):
    """(port EfficientDet, its JAX-layout param tree) for config ``jcfg``:
    the port's JAX-free init, the fusion weights ``wsm`` drawn from
    U(-0.3, 1.5) (so relu and the normalisation act), each BN's gamma from
    U(0.8, 1.2) and beta from N(0, 0.2), and then each BN site's statistics
    set from its input on ``images`` (uint8 [B, h, w, 3]):
    ``calibrating_bn``. With the init's identity statistics the
    activations shrink by ~100x at every depthwise conv and the comparison
    would only see zeros; calibrated, every level carries unit-scale
    features and the class logits spread around the prior. As
    ``jax_params`` does for ResNet, each MBConv's project BN gamma is
    scaled by 0.2: random blocks at full gain amplify float32 rounding
    ~1.3x each, so that after B0's 16 blocks and two BiFPN cells JAX's own
    jitted and eager forwards differ by 1.2e-5 of the largest probability
    (1e-6 with the scaling). The box net's last conv is scaled by 0.1
    (below)."""
    import torch

    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            params_from_jax,
                                                            params_to_jax)
    cfg = port_config(jcfg)
    tree = init_params(cfg, seed, "efficientdet")
    rng = np.random.RandomState(seed)
    for name, leaf in flat(tree).items():
        node = tree
        parts = name.split("/")
        for k in parts[:-1]:
            node = node[k]
        if parts[-1] == "wsm":
            node["wsm"] = rng.uniform(-0.3, 1.5, leaf.shape).astype(
                np.float32)
        elif parts[-1] == "gamma":
            node["gamma"] = rng.uniform(0.8, 1.2, leaf.shape).astype(
                np.float32)
        elif parts[-1] == "beta":
            node["beta"] = (0.2 * rng.randn(*leaf.shape)).astype(np.float32)
    # box deltas of a trained regressor's scale (std ~0.1, not ~1): a
    # float32 rounding of a delta moves a box by the delta's error times
    # the anchor's size (up to 645 px at P7)
    tree["box_net"]["predict"]["pw"]["W"] *= 0.1
    for gname, group in tree["backbone"].items():
        if gname.startswith("group"):
            for blk in group.values():
                blk["project"]["bn"]["gamma"] *= 0.2
    model = params_from_jax(tree, get_model(cfg, "efficientdet"))
    with torch.no_grad():
        feats = model.features(torch.from_numpy(images), bn=calibrating_bn)
        model.heads(feats, bn=calibrating_bn)
    return model, params_to_jax(model)


# --------------------------------------------------------------------------
# ReID


def reid_net(name, seed=0, size=(64, 32), batch=4):
    """The port's ReID net ``name`` (eval, float32, CPU) with torchreid's
    initial weights from ``seed``, each residual branch's last BN gamma
    (or OSBlockINin's IN gamma) scaled by 0.2, then every BatchNorm2d's
    running statistics measured on a seeded batch of normal images of
    ``size``. With the init's unit statistics a random OSNet's features
    vary across inputs by ~1e-2 of their size: every crop would look
    alike. The fc heads' BN1d keeps unit statistics: measured on a few
    alike samples, its variances are ~1e-5 and it would blow float32
    rounding up ~100x. So does every BatchNorm2d that sees 1x1 maps (MLFN's
    factor-selection gates and projections, HA-CNN's channel attention):
    measured there, MLFN's smallest variance is 4e-5 and float32 forwards
    of both packages land 0.6-2.3% of the output's magnitude from a
    float64 one. Inception-v4, a deep stack of BN-ReLU convs without a
    residual, gets every BatchNorm2d's beta 1 before the measure: with
    beta 0 and measured statistics the random net is chaotic (its float32
    forward 3e-5 of the output's magnitude from a float64 one at 96x80
    and 7e-4 at 256x128, bf16 against float32 a row cosine of 0.75 there),
    and unit statistics make its features barely depend on the input (a
    cosine of 0.998 between two inputs' features); with beta 1, 1.3e-6
    and 5e-6 from float64, bf16 cosine 0.998 and cosine 0.88 between two
    inputs at 256x128."""
    import torch
    from torch import nn

    from object_detection_tracking_tpu_torch.models.reid import (
        ibn_reid, inceptionv4_reid, mlfn_reid, mobilenetv2, osnet,
        resnet_reid, senet_reid)
    from object_detection_tracking_tpu_torch.models.reid.extractor import \
        build_reid_model
    torch.manual_seed(seed)
    net = build_reid_model(name)
    plain = isinstance(net, inceptionv4_reid.InceptionV4ReID)
    bns = []
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (resnet_reid.Bottleneck, senet_reid.SEBottleneck,
                              ibn_reid.IBNBottleneck)):
                m.bn3.weight.mul_(0.2)
            elif isinstance(m, mlfn_reid.MLFNBlock):
                m.fm_bn3.weight.mul_(0.2)
            elif isinstance(m, mobilenetv2.MobileBottleneck) \
                    and m.use_residual:
                m.conv3[1].weight.mul_(0.2)
            elif isinstance(m, resnet_reid.BasicBlock):
                m.bn2.weight.mul_(0.2)
            elif isinstance(m, (osnet.OSBlock, osnet.OSBlockAIN)):
                last = m.conv3.bn if m.conv3.bn is not None else m.IN
                last.weight.mul_(0.2)
            if isinstance(m, nn.BatchNorm2d):
                m.momentum = None     # running stats = this batch's
                m.reset_running_stats()
                if plain:
                    m.bias.fill_(1.0)
                bns.append(m)
        x = torch.randn(batch, 3, *size,
                        generator=torch.Generator().manual_seed(seed + 1))
        net.train()
        for m in net.modules():
            if isinstance(m, nn.BatchNorm1d):
                m.eval()
        pointwise = set()
        hooks = [m.register_forward_hook(
            lambda m, inp, out: pointwise.add(m)
            if inp[0].shape[2:].numel() == 1 else None) for m in bns]
        net(x)
        for h in hooks:
            h.remove()
    for m in bns:
        m.momentum = 0.1
        if m in pointwise:
            m.reset_running_stats()
    return net.eval()
