"""The port's Faster-RCNN-FPN against the JAX model, stage by stage, on the
CPU in float32, for R18, R50 partial-COCO (the main path's configuration at
a small size) and R50 version-4 (dilated c5, class-agnostic head).

Params come from the JAX init_params through params_from_jax; inputs are
numpy arrays from a fixed seed. The sort-sensitive stages (proposals,
per-class NMS) are fed the JAX stage's own inputs, so they are compared on
identical numbers.

Tolerances: dense stages agree to float32 rounding of differently ordered
sums (conv algorithms differ between XLA and torch); we allow 1e-4
relative to the largest magnitude of each output. Boxes in image pixels
get 1e-3 px. Labels, validity and NMS picks must be equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu.models.resnet import resnet_c2345  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.params import params_from_jax  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import CONFIGS, H, W, close, jax_params  # noqa: E402

B = 2


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    cfg = CONFIGS[request.param]()
    jm = jax_model(cfg)
    params = jax_params(jm)
    tm = params_from_jax(params, get_model(cfg))
    return cfg, jm, params, tm


def images(seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (B, H, W, 3)).astype(np.uint8)


def jax_stages(cfg, jm, params, imgs):
    """The JAX forward's intermediates, computed with its own functions."""
    h, w = imgs.shape[1:3]
    hp, wp, fields, valids = jm._static_geometry(h, w)
    p_images = jm.preprocess(jnp.asarray(imgs), hp, wp, s2d=True)
    c2345 = resnet_c2345(params["resnet"], p_images, cfg.resnet_num_block,
                         use_basic_block=cfg.use_basic_block,
                         use_dilations=cfg.use_dilations, freeze=-1)
    p23456 = jm.backbone(params, p_images)
    ll, bl = jm._rpn_all_levels(params, p23456)
    prop_boxes, prop_valid = jax.vmap(
        lambda *lv: jm._proposals_single(
            lv[:cfg.num_levels], lv[cfg.num_levels:], fields, valids,
            h, w))(*ll, *bl)
    roi = jm._roi_align_batched(p23456, prop_boxes, 7, valid=prop_valid)
    label_out, box_out = jm._apply_head(params, roi, prop_boxes)
    b, k = prop_boxes.shape[:2]
    if cfg.use_frcnn_class_agnostic:
        box_out = jnp.broadcast_to(box_out, (b, k, jm.num_out_class - 1, 4))
    if jm.partial_label_idx is not None:
        label_out = label_out[:, :, jm.partial_label_idx]
        if not cfg.use_frcnn_class_agnostic:
            box_out = box_out[:, :, jm.partial_box_idx, :]
    from object_detection_tracking_tpu.ops.boxes import (clip_boxes,
                                                         decode_boxes)
    reg_w = jnp.asarray(cfg.fastrcnn_bbox_reg_weights, jnp.float32)
    decoded = clip_boxes(decode_boxes(box_out / reg_w, prop_boxes[:, :, None],
                                      cfg.bbox_decode_clip), (h, w))
    probs = jax.nn.softmax(label_out, axis=-1)
    n = lambda x: np.asarray(x)  # noqa: E731
    return dict(c2345=[n(c) for c in c2345], p23456=[n(p) for p in p23456],
                ll=[n(x) for x in ll], bl=[n(x) for x in bl],
                prop_boxes=n(prop_boxes), prop_valid=n(prop_valid),
                roi=n(roi), label_out=n(label_out), decoded=n(decoded),
                probs=n(probs))


@pytest.fixture(scope="module")
def stages(models):
    cfg, jm, params, _ = models
    return jax_stages(cfg, jm, params, images())


def test_backbone_fpn_rpn_match(models, stages):
    cfg, _, _, tm = models
    hp, wp, _, _ = tm._static_geometry(H, W)
    p_images = tm.preprocess(torch.from_numpy(images()), hp, wp)
    c2345 = tm.resnet(p_images.permute(0, 3, 1, 2))
    for got, ref in zip(c2345, stages["c2345"]):
        close(got.permute(0, 2, 3, 1), ref)
    p23456 = [p.permute(0, 2, 3, 1) for p in tm.fpn(c2345)]
    assert len(p23456) == 5
    for got, ref in zip(p23456, stages["p23456"]):
        close(got, ref)
    ll, bl = tm._rpn_all_levels([torch.from_numpy(p)
                                 for p in stages["p23456"]])
    for got, ref in zip(ll + bl, stages["ll"] + stages["bl"]):
        close(got, ref)


def test_proposals_match_on_jax_logits(models, stages):
    cfg, _, _, tm = models
    _, _, fields, valids = tm._static_geometry(H, W)
    boxes, valid = tm._proposals(
        [torch.from_numpy(x) for x in stages["ll"]],
        [torch.from_numpy(x) for x in stages["bl"]], fields, valids, H, W)
    assert stages["prop_valid"].any()
    np.testing.assert_array_equal(valid.numpy(), stages["prop_valid"])
    np.testing.assert_allclose(boxes.numpy(), stages["prop_boxes"],
                               atol=1e-3, rtol=0)


def test_head_matches_on_jax_roi_features(models, stages):
    _, _, _, tm = models
    label_out, _ = tm._apply_head(torch.from_numpy(stages["roi"]))
    if tm.partial_label_idx is not None:
        label_out = label_out[:, :, tm.partial_label_idx]
    close(label_out, stages["label_out"])


def test_predictions_match_on_jax_inputs(models, stages):
    cfg, jm, _, tm = models
    ref = jax.vmap(jm._predictions_single)(
        jnp.asarray(stages["decoded"]), jnp.asarray(stages["probs"]),
        jnp.asarray(stages["prop_valid"]))
    ref = [np.asarray(x) for x in ref]
    got = [x.numpy() for x in tm._predictions(
        torch.from_numpy(stages["decoded"]), torch.from_numpy(stages["probs"]),
        torch.from_numpy(stages["prop_valid"]))]
    assert ref[3].any()
    np.testing.assert_array_equal(got[3], ref[3])          # valid
    np.testing.assert_array_equal(got[1], ref[1])          # labels
    np.testing.assert_array_equal(got[4], ref[4])          # class idx
    np.testing.assert_allclose(got[0], ref[0], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-6, rtol=0)
