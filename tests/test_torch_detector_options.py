"""The detector's architecture options in the port against the JAX package
on the CPU, in float32: GroupNorm, the deformable conv, the relation
network, the box head's conv/attention/relation variants, the whole
forward under each option and under four together, the padded-slot rule
of the relation head (ROADMAP C14), and the init trees.

The JAX side is jitted, and each JAX computation runs once. The forwards
take one tree for both packages, torch_port_common.option_tree: the
port's init (``test_init_tree_matches_jax`` holds its key set and shapes
to JAX's ``init_params``), conditioned as that helper says. The forwards hold
the outputs to the existing forward tests' tolerances
(torch_port_common.compare_forward): valid slots and labels equal, boxes
within 1e-3 px, probabilities within 1e-5, the embeddings within 1e-4 of
their largest magnitude. The box head is 256 wide (1024 by default): with
random weights the relation's attention logits grow with the width and
amplify float32 rounding into the probabilities. At 1024 the relation
forward's probabilities differed from a float64 run of the port by
1.26e-5 in the port's float32 and by 4.5e-6 in JAX's (the relation module
alone: 9.1e-7 and 2.0e-6 of its largest output); at 256 the port and JAX
differ by 4.6e-6.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from object_detection_tracking_tpu.config import DetectorConfig  # noqa: E402
from object_detection_tracking_tpu.models import deformable as jdef  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu.models import heads as jheads  # noqa: E402
from object_detection_tracking_tpu.models import relation as jrel  # noqa: E402
from object_detection_tracking_tpu.models.layers import conv2d as jconv2d  # noqa: E402
from object_detection_tracking_tpu.ops import norm as jnorm  # noqa: E402
from object_detection_tracking_tpu_torch.config import \
    DetectorConfig as PortConfig  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.models import deformable as tdef  # noqa: E402
from object_detection_tracking_tpu_torch.models import relation as trel  # noqa: E402
from object_detection_tracking_tpu_torch.models.heads import \
    FastRCNN2FCHead  # noqa: E402
from object_detection_tracking_tpu_torch.models.layers import Conv  # noqa: E402
from object_detection_tracking_tpu_torch.models.resnet import ResNet  # noqa: E402
from object_detection_tracking_tpu_torch.ops import norm as tnorm  # noqa: E402
from object_detection_tracking_tpu_torch.params import (init_params,  # noqa: E402
                                                        params_from_jax)
from torch_port_common import _init_tree, close, flat, option_tree  # noqa: E402

H, W = 64, 128
OPTIONS = {
    "gn": dict(use_gn=True),
    "deformable": dict(use_deformable=True, resnet_depth=50),
    "relation": dict(add_relation_nn=True),
    "attention": dict(use_att_frcnn_head=True),
    "conv_head": dict(use_conv_frcnn_head=True),
    "four": dict(use_gn=True, use_deformable=True, add_relation_nn=True,
                 use_att_frcnn_head=True, resnet_depth=50),
}
# every proposal slot valid at this top-k (asserted below); a narrow box
# head (module note)
BASE = dict(num_class=5, resnet_depth=18, short_edge_size=H, max_size=W,
            rpn_test_post_nms_topk=16, result_per_im=8,
            fpn_frcnn_fc_head_dim=256,
            compute_dtype="float32", rpn_topk_recall=1.0,
            roi_align_impl="xla")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module, as
    tests/test_torch_effdet_train.py pins it: alone the module takes as
    long with one as with eight, and among the suite's parallel workers a
    process's many threads wait for each other at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(x):
    return torch.from_numpy(np.array(x, np.float32))


def _nchw(x):
    return _torch(x).permute(0, 3, 1, 2)


def images(seed=1, b=2):
    return np.random.RandomState(seed).randint(0, 256, (b, H, W, 3)
                                               ).astype(np.uint8)


# --------------------------------------------------------------------------
# modules


@pytest.mark.parametrize("c", [256, 8])
def test_group_norm_matches_jax(c):
    """min(32, C) groups: 32 groups of 8 at C=256, 8 groups of 1 at C=8."""
    rng = np.random.RandomState(c)
    x = (rng.randn(2, 5, 6, c) * 3 + 1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    ref = jax.jit(jnorm.group_norm)({"gamma": gamma, "beta": beta}, x)
    gn = tnorm.GroupNorm(c)
    gn.gamma.data, gn.beta.data = _torch(gamma), _torch(beta)
    got = tnorm.group_norm(gn, _nchw(x)).permute(0, 2, 3, 1)
    close(got.numpy(), ref, rel=1e-5)


DEFORM_CASES = [("random", 1), ("random", 2), ("zero", 1), ("zero", 2)]


@pytest.mark.parametrize("offsets,stride", DEFORM_CASES)
def test_deformable_conv2d_matches_jax(offsets, stride):
    """Random offsets of a few pixels (taps past every edge of the 9x11
    map, so the clamp shows) against JAX; zero offsets against a SAME conv
    on the interior (the clamp replicates the border where a conv pads
    zeros), at stride 1 and 2."""
    rng = np.random.RandomState(stride)
    c, c_out = 8, 12
    x = rng.randn(2, 9, 11, c).astype(np.float32)
    p = jdef.init_deformable_conv(jax.random.PRNGKey(stride), c, c_out)
    p = jax.tree.map(np.asarray, p)
    if offsets == "random":
        p["offset"]["W"] = (rng.randn(*p["offset"]["W"].shape) * 0.4
                            ).astype(np.float32)
        p["offset"]["b"] = (rng.randn(18) * 1.5).astype(np.float32)
    else:
        p["offset"]["W"] = np.zeros_like(p["offset"]["W"])
    off = Conv(3, c, 18)
    off.weight.data = _torch(p["offset"]["W"]).permute(3, 2, 0, 1)
    off.bias.data = _torch(p["offset"]["b"])
    weight = _torch(p["W"]).permute(3, 2, 0, 1)
    with torch.no_grad():
        got = tdef.deformable_conv2d(off, weight, _nchw(x), stride)
    got = got.permute(0, 2, 3, 1).numpy()
    if offsets == "random":
        o = np.asarray(jconv2d(p["offset"], x, stride=stride,
                               padding=((1, 1), (1, 1))))
        assert np.abs(o).max() > 3     # taps well past the edges
        ref = jax.jit(partial(jdef.deformable_conv2d, stride=stride))(p, x)
        close(got, ref, rel=1e-5)
    else:
        plain = torch.nn.functional.conv2d(_nchw(x), weight, None, stride, 1)
        plain = plain.permute(0, 2, 3, 1).numpy()
        assert got.shape == plain.shape
        close(got[:, 1:-1, 1:-1], plain[:, 1:-1, 1:-1], rel=1e-5)


def _relation_case(k=12, d=64, seed=0):
    rng = np.random.RandomState(seed)
    p = jax.tree.map(np.asarray, jrel.init_relation(
        jax.random.PRNGKey(seed), d))
    xy = rng.uniform(0, 80, (k, 2))
    wh = rng.uniform(4, 40, (k, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    feat = rng.randn(k, d).astype(np.float32)
    mod = trel.Relation(d)
    params_from_jax(p, mod)
    return p, mod, feat, boxes


def test_relation_network_matches_jax():
    p, mod, feat, boxes = _relation_case()
    ref = jax.jit(jrel.relation_network)(p, feat, boxes)
    with torch.no_grad():
        got = trel.relation_network(mod, _torch(feat)[None],
                                    _torch(boxes)[None])
    close(got[0].numpy(), ref, rel=1e-5)


HEAD_CASES = {
    "conv": dict(use_conv_head=True),
    "attention": dict(use_att_head=True),
    "relation": dict(add_relation_nn=True),
    "relation_attention": dict(add_relation_nn=True, use_att_head=True),
}


@pytest.mark.parametrize("agnostic", [False, True])
@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_head_variant_matches_jax(case, agnostic):
    kw = HEAD_CASES[case]
    rng = np.random.RandomState(3)
    num_class, c, fc, k = 5, 16, 64, 10
    p = jax.tree.map(np.asarray, jheads.init_fastrcnn_2fc_head(
        jax.random.PRNGKey(3), num_class, c, 7, fc, agnostic,
        conv_dim=8, **kw))
    feature = rng.randn(k, 7, 7, c).astype(np.float32)
    xy = rng.uniform(0, 60, (k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (k, 2))], 1
                           ).astype(np.float32)
    ref = jax.jit(partial(jheads.fastrcnn_2fc_head, num_class=num_class,
                          class_agnostic=agnostic))(p, feature, boxes=boxes)
    head = params_from_jax(p, FastRCNN2FCHead(
        num_class, c, 7, fc, agnostic, conv_dim=8,
        add_relation_nn=kw.get("add_relation_nn", False),
        use_att_head=kw.get("use_att_head", False),
        use_conv_head=kw.get("use_conv_head", False)))
    with torch.no_grad():
        got = head(_torch(feature), _torch(boxes)[None])
    for g, r in zip(got, ref):
        close(g.numpy(), r, rel=1e-5)


# --------------------------------------------------------------------------
# the whole forward


def _cfg(name, **extra):
    return DetectorConfig(**{**BASE, **OPTIONS[name], **extra})


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_forward_matches_jax(name):
    cfg = _cfg(name)
    tree = option_tree(cfg)
    tm = params_from_jax(tree, get_model(PortConfig(
        **dataclasses.asdict(cfg))))
    imgs = images()
    with torch.inference_mode():
        x = torch.from_numpy(imgs)
        hp, wp, fields, valids = tm._static_geometry(H, W)
        p23456 = tm.backbone(tm.preprocess(x, hp, wp))
        _, prop_valid = tm._proposals(*tm._rpn_all_levels(p23456), fields,
                                      valids, H, W)
        got = {k: v.numpy() for k, v in tm(x).items()}
    assert prop_valid.all()       # no padded slot: JAX's relation is finite
    if cfg.use_deformable:        # deformable groups run unfused
        assert tm.resnet.fused_groups == []
    ref = {k: np.asarray(v) for k, v in
           jax.jit(jax_model(cfg).forward)(tree, imgs).items()}
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


def test_fused_stages_skip_deformable_groups():
    """backbone_impl="pallas": a group with a deformable block runs
    unfused (JAX resnet.py:253-254); at R101 v4 c2 alone is fused."""
    for deform, want in ((False, [0, 1, 2]), (True, [0])):
        cfg = PortConfig.from_version(4, use_deformable=deform,
                                      backbone_impl="pallas")
        net = ResNet(cfg.resnet_num_block, cfg.use_basic_block,
                     use_dilations=cfg.use_dilations,
                     use_deformable=cfg.use_deformable, fused_stages=True)
        assert net.fused_groups == want, deform


# --------------------------------------------------------------------------
# ROADMAP C14: padded proposal slots


def test_relation_with_padded_slots_equals_jax_on_the_valid_boxes():
    """Five slots, the fourth padding (a zero box, as JAX's invalid
    proposals are): JAX's relation_network gives NaN in every row; the
    port's valid rows equal JAX's on the four valid boxes alone, its
    padded row is 0."""
    p, mod, feat, boxes = _relation_case(k=5, seed=4)
    boxes[3] = 0.0
    valid = np.ones(5, bool)
    valid[3] = False
    fn = jax.jit(jrel.relation_network)
    assert np.isnan(np.asarray(fn(p, feat, boxes))).all(axis=1).all()
    ref = np.asarray(fn(p, feat[valid], boxes[valid]))
    assert np.isfinite(ref).all()
    with torch.no_grad():
        got = trel.relation_network(mod, _torch(feat)[None],
                                    _torch(boxes)[None],
                                    torch.from_numpy(valid)[None])[0].numpy()
    close(got[valid], ref, rel=1e-5)
    assert not got[3].any()


def test_relation_forward_with_padded_slots():
    """Proposal top-k 300 on a 64x128 image leaves padded slots: JAX's
    forward returns no valid detection, the port's returns some, all
    finite."""
    cfg = _cfg("relation", rpn_test_post_nms_topk=300)
    tree = option_tree(cfg)
    imgs = images()
    ref = jax.jit(jax_model(cfg).forward)(tree, imgs)
    assert not np.asarray(ref["final_valid"]).any()
    tm = params_from_jax(tree, get_model(PortConfig(
        **dataclasses.asdict(cfg))))
    with torch.inference_mode():
        x = torch.from_numpy(imgs)
        hp, wp, fields, valids = tm._static_geometry(H, W)
        p23456 = tm.backbone(tm.preprocess(x, hp, wp))
        _, prop_valid = tm._proposals(*tm._rpn_all_levels(p23456), fields,
                                      valids, H, W)
        got = tm(x)
    assert not prop_valid.all(axis=1).any()    # each image has padding
    assert got["final_valid"].any()
    for k in ("final_boxes", "final_probs", "pooled_box_feat"):
        assert torch.isfinite(got[k]).all(), k


# --------------------------------------------------------------------------
# init trees


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_init_tree_matches_jax(name):
    """The port's init_params draws the same leaves, with the same shapes,
    as JAX's init_params under each option."""
    cfg = _cfg(name)
    ref = jax.eval_shape(jax_model(cfg).init_params, jax.random.PRNGKey(0))
    got = flat(_init_tree(cfg))
    ref = {k: tuple(v.shape) for k, v in flat_shapes(ref).items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == ref


def flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_shapes(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def test_small_object_head_refused_naming_a8b():
    """The small-object heads, once refused naming ROADMAP A8b, are
    ported: the default configuration (at R18) with use_small_object_head
    (and the person association) builds a model with JAX's small_objects
    tree, whose leaves init_params draws with JAX's names and shapes.
    tests/test_torch_small_object.py holds their outputs to JAX's."""
    for assoc in (False, True):
        cfg = PortConfig(use_small_object_head=True, resnet_depth=18,
                         use_so_association=assoc)
        model = get_model(cfg)
        tree = init_params(cfg)
        jcfg = DetectorConfig(**dataclasses.asdict(cfg))
        ref = jax.eval_shape(jax_model(jcfg).init_params,
                             jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in flat(tree).items()} == \
            {k: tuple(v.shape) for k, v in flat_shapes(ref).items()}
        assert set(model.small_objects) == set(tree["small_objects"])
        params_from_jax(tree, model)
