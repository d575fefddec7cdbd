"""The port's EfficientDet inference forward against the JAX package's, on
the CPU: efficientdet-test (128 px, 32 filters, B0 backbone), float32,
``roi_align_impl="xla"``, the same numpy inputs, params carried over by
``params_from_jax`` (the port's JAX-free init with each BN calibrated on
the test images, tests/torch_port_common.py effdet_params). JAX runs
jitted; the I420 case feeds JAX the frames converted by its eager
``i420_to_bgr`` (ROADMAP C1).

Tolerances: feature maps within 1e-4 of their largest magnitude (the same
float32 ops, sums in another order); labels, levels and ``final_valid``
equal; boxes within 1e-3 px; probabilities and ``pooled_box_feat`` within
1e-5 of their largest magnitude.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from object_detection_tracking_tpu.config import DetectorConfig  # noqa: E402
from object_detection_tracking_tpu.models import efficientdet as JED  # noqa: E402
from object_detection_tracking_tpu.models.efficientdet import efficientdet as JEDM  # noqa: E402
from object_detection_tracking_tpu.models.efficientdet import efficientnet as JEN  # noqa: E402
from object_detection_tracking_tpu.models.faster_rcnn import FasterRCNNFPN as JFR  # noqa: E402
from object_detection_tracking_tpu_torch.models import efficientdet as TED  # noqa: E402
from object_detection_tracking_tpu_torch.models.efficientdet import efficientdet as TEDM  # noqa: E402
from object_detection_tracking_tpu_torch.models.efficientdet import efficientnet as TEN  # noqa: E402
from object_detection_tracking_tpu_torch.params import (  # noqa: E402
    _Init, _init_efficientnet, params_from_jax, params_to_jax)
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import calibrating_bn, close, effdet_params  # noqa: E402

H, W = 96, 128
BASE = dict(result_per_im=10, compute_dtype="float32",
            efficientdet_name="efficientdet-test", roi_align_impl="xla")
SUM_ENTRY = ("efficientnet-b0", 128, 32, 2, 2, "sum", 4.0)


def frames(seed=0, b=2):
    return np.random.RandomState(seed).randint(
        0, 255, (b, H, W, 3)).astype(np.uint8)


def nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, port model, tree) for efficientdet-test, full COCO."""
    cfg = DetectorConfig.coco(**BASE)
    tm, tree = effdet_params(cfg, frames(1))
    return JED.EfficientDet(cfg), tm, tree


@pytest.fixture(scope="module")
def jax_forward(tiny):
    return jax.jit(tiny[0].forward)


def test_anchors_and_decode_match_jax():
    for size, scale in ((128, 4.0), (512, 4.0), (1536, 5.0)):
        for a, b in zip(JED.effdet_anchors((size, size), anchor_scale=scale),
                        TED.effdet_anchors((size, size), anchor_scale=scale)):
            assert np.array_equal(a, b)
    rng = np.random.RandomState(0)
    deltas = rng.randn(500, 4).astype(np.float32)
    xy = rng.uniform(0, 400, (500, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(4, 300, (500, 2))],
                             -1).astype(np.float32)
    ref = np.asarray(JED.decode_effdet_boxes(jnp.asarray(deltas),
                                             jnp.asarray(anchors)))
    got = TED.decode_effdet_boxes(torch.from_numpy(deltas),
                                  torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("name", ["efficientnet-b0", "efficientnet-lite0"])
def test_efficientnet_endpoints_match_jax(name, tiny):
    """C3, C4, C5 of B0 (squeeze-excite, swish; the tiny model's backbone)
    and of lite0 (no SE, relu6), on the same normalised input."""
    if name == "efficientnet-b0":
        net, tree = tiny[1].backbone, tiny[2]["backbone"]
    x = np.random.RandomState(2).randn(2, 128, 128, 3).astype(np.float32)
    if name != "efficientnet-b0":
        net = params_from_jax(_init_efficientnet(_Init(3), name),
                              TEN.EfficientNet(name))
        with torch.no_grad():
            net(nchw(x), bn=calibrating_bn)
        tree = params_to_jax(net)
    ref = jax.jit(JEN.efficientnet_c345, static_argnums=2)(tree, x, name)
    with torch.no_grad():
        got = net(nchw(x))
    assert len(got) == 3
    for g, r in zip(got, ref):
        assert np.abs(r).max() > 1e-3
        close(nhwc(g), r)


def _cell_inputs(model, seed):
    """Cell 0's inputs: raw C3..C5 at the backbone's channels, P6, P7."""
    rng = np.random.RandomState(seed)
    c3, c4, c5 = TEDM.backbone_channels(model.backbone_name)
    c = model.fpn_filters
    shapes = [(16, c3), (8, c4), (4, c5), (2, c), (1, c)]
    return [rng.randn(2, s, s, ch).astype(np.float32) for s, ch in shapes]


@pytest.mark.parametrize("fusion", ["fastattn", "sum"])
def test_bifpn_cell_matches_jax(fusion, tiny, monkeypatch):
    """BiFPN cell 0 (with its channel resamples) and cell 1, in
    fast-attention fusion (efficientdet-test, random ``wsm`` with negative
    entries) and in unweighted-sum fusion (d6/d7's, through a test entry
    shaped like efficientdet-test)."""
    if fusion == "fastattn":
        jm, tm, tree = tiny
    else:
        for mod in (JEDM, TEDM):
            monkeypatch.setitem(mod.EFFICIENTDET_CONFIGS,
                                "efficientdet-test-sum", SUM_ENTRY)
        cfg = DetectorConfig.coco(**{**BASE, "efficientdet_name":
                                     "efficientdet-test-sum"})
        tm, tree = effdet_params(cfg, frames(1), seed=4)
        jm = JED.EfficientDet(cfg)
        assert "wsm" not in tree["fpn_cells"]["cell_0"]["fnode0"]
    assert tm.fusion == jm.fusion == fusion
    feats = _cell_inputs(tm, 5)
    for rep in range(2):
        cell = tree["fpn_cells"][f"cell_{rep}"]
        ref = jax.jit(jm._bifpn_cell)(cell, feats)
        with torch.no_grad():
            got = tm._bifpn_cell(tm.fpn_cells[f"cell_{rep}"],
                                 [nchw(f) for f in feats])
        for g, r in zip(got, ref):
            close(nhwc(g), r)
        feats = [np.asarray(r) for r in ref]


def test_heads_match_jax(tiny):
    """The class and box nets over P3..P7 (shared convs, per-level BN, the
    residual from the second repeat on)."""
    jm, tm, tree = tiny
    rng = np.random.RandomState(6)
    feats = [rng.randn(2, s, s, 32).astype(np.float32)
             for s in (16, 8, 4, 2, 1)]
    ref_cls, ref_box = jax.jit(jm._heads)(tree, feats)
    with torch.no_grad():
        got_cls, got_box = tm.heads([nchw(f) for f in feats])
    for g, r in zip(got_cls + got_box, list(ref_cls) + list(ref_box)):
        close(nhwc(g), r)


def compare_outputs(got, ref):
    assert set(got) == set(ref) == {"final_boxes", "final_labels",
                                    "final_probs", "final_valid",
                                    "pooled_box_feat"}
    valid = ref["final_valid"]
    assert valid.sum() >= 10
    np.testing.assert_array_equal(got["final_valid"], valid)
    np.testing.assert_array_equal(got["final_labels"], ref["final_labels"])
    np.testing.assert_allclose(got["final_boxes"], ref["final_boxes"],
                               atol=1e-3, rtol=0)
    close(got["final_probs"], ref["final_probs"], 1e-5)
    close(got["pooled_box_feat"], ref["pooled_box_feat"], 1e-5)
    assert np.abs(ref["pooled_box_feat"]).max() > 1e-2


def port_forward(tm, images):
    with torch.inference_mode():
        return {k: v.numpy() for k, v in tm(torch.from_numpy(images)).items()}


def levels_of(tm, images):
    """The port's per-detection source levels for ``images``."""
    with torch.inference_mode():
        x = torch.from_numpy(images)
        cls_flat, box_flat = tm.flat_heads(*tm.heads(tm.features(x)))
        return tm.postprocess(cls_flat, box_flat, images.shape[1:3])[4]


def test_forward_matches_jax(tiny, jax_forward):
    jm, tm, tree = tiny
    x = frames(0).astype(np.float32)
    ref = {k: np.asarray(v) for k, v in jax_forward(tree, x).items()}
    got = port_forward(tm, x)
    compare_outputs(got, ref)
    assert len(np.unique(ref["final_labels"])) > 3
    # the source levels: JAX's, recomputed from its own flat heads
    @jax.jit
    def jax_levels(tree, x):
        _, cls_flat, box_flat, anchors, alevels, hw, _ = \
            jm._features_and_flat_heads(tree, x)
        return jax.vmap(lambda c, b: jm._postprocess_single(
            c, b, anchors, alevels, hw)[4])(cls_flat, box_flat)
    np.testing.assert_array_equal(levels_of(tm, x).numpy(),
                                  np.asarray(jax_levels(tree, x)))


def test_forward_partial_classes_matches_jax(tiny):
    """``config.partial_classes``: the tracked classes' score columns only,
    labels numbered in the partial taxonomy."""
    cfg = DetectorConfig.coco_partial(**BASE)
    jm = JED.EfficientDet(cfg)
    tm = params_from_jax(tiny[2], TEDM.EfficientDet(
        tiny[1].config.__class__(**dataclasses.asdict(cfg))))
    x = frames(3).astype(np.float32)
    ref = {k: np.asarray(v) for k, v in
           jax.jit(jm.forward)(tiny[2], x).items()}
    got = port_forward(tm, x)
    compare_outputs(got, ref)
    assert ref["final_labels"].max() <= len(cfg.partial_classes)


def test_forward_i420_matches_jax_eager_conversion(tiny, jax_forward):
    """I420 frames: the port converts them on the device; JAX gets the
    same frames through its eager ``i420_to_bgr`` (its jitted forward
    rounds the fused conversion differently, ROADMAP C1)."""
    _, tm, tree = tiny
    bgr = frames(7)
    y = bgr.mean(-1).astype(np.uint8)
    uv = bgr[:, ::2, ::2, :2].mean(-1).astype(np.uint8)
    i420 = np.concatenate([
        y, uv.reshape(2, H // 4, W), (255 - uv).reshape(2, H // 4, W)], 1)
    conv = np.asarray(JFR.i420_to_bgr(jnp.asarray(i420)), np.float32)
    ref = {k: np.asarray(v) for k, v in jax_forward(tree, conv).items()}
    got = port_forward(tm, i420)
    compare_outputs(got, ref)
