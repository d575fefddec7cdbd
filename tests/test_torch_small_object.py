"""The small-object heads (``use_small_object_head``, ``use_so_association``,
``use_so_score_thres``; ROADMAP A8b) in the port against the JAX package
on the CPU, in float32: the params' round trip, the SO outputs of the
forward and the padded-slot rule (ROADMAP C18). Training, ROIAlign's box
gradient and the train CLI are in tests/test_torch_small_object_train.py.

R18 at 64x128 with ActEV's 16 classes, whose small objects are Prop,
Push_Pulled_Object and Bike (Prop_plus_Push_Pulled_Object is not in the
class map), and a 256-wide box head (tests/test_torch_detector_options.py
says why). The tree is the port's init, conditioned as
torch_port_common.option_tree says. The forwards keep every SO slot and
person reference valid (asserted), where the port computes JAX's function;
the padded case is a case of its own. The JAX side is jitted and each JAX
computation runs once.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from object_detection_tracking_tpu.config import DetectorConfig  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu.models import relation as jrel  # noqa: E402
from object_detection_tracking_tpu_torch.config import \
    DetectorConfig as PortConfig  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.models import relation as trel  # noqa: E402
from object_detection_tracking_tpu_torch.ops.boxes import (  # noqa: E402
    clip_boxes, decode_boxes)
from object_detection_tracking_tpu_torch.params import (  # noqa: E402
    init_params, load_npz_tree, params_from_jax, params_to_jax,
    save_npz_tree)
from torch_port_common import (close, flat, option_tree,  # noqa: E402
                               port_config)

H, W = 64, 128
# every SO slot and person reference valid at this top-k (asserted)
BASE = dict(num_class=16, resnet_depth=18, short_edge_size=H, max_size=W,
            rpn_test_post_nms_topk=64, result_per_im=8, so_person_topk=4,
            fpn_frcnn_fc_head_dim=256, compute_dtype="float32",
            rpn_topk_recall=1.0, roi_align_impl="xla",
            use_small_object_head=True)
# association off with the score cut (at a threshold that takes some
# slots), association on without it
VARIANTS = {"score_thres": dict(use_so_score_thres=True,
                                result_score_thres=0.37),
            "association": dict(use_so_association=True)}
# 32 proposals for R = 32 slots a class and 32 references: NMS leaves
# padding in every SO class and among the person references
PADDED = dict(rpn_test_post_nms_topk=32, result_per_im=32,
              so_person_topk=32, use_so_association=True)
SO_KEYS = ("so_final_boxes", "so_final_labels", "so_final_probs",
           "so_final_valid")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (as
    tests/test_torch_detector_options.py pins it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return DetectorConfig(**{**BASE, **kw})


def images(seed=1, b=2):
    return np.random.RandomState(seed).randint(0, 256, (b, H, W, 3)
                                               ).astype(np.uint8)


def so_inputs(tm, imgs):
    """The port's inputs to ``_so_core`` for a batch: (p23456, decoded
    boxes [B, K, C-1, 4], probs [B, K, C], proposal validity [B, K])."""
    cfg = tm.config
    with torch.inference_mode():
        x = torch.from_numpy(imgs)
        hp, wp, fields, valids = tm._static_geometry(H, W)
        p23456 = tm.backbone(tm.preprocess(x, hp, wp))
        boxes, valid = tm._proposals(*tm._rpn_all_levels(p23456), fields,
                                     valids, H, W)
        label_out, box_out = tm._apply_head(
            tm._roi_align_batched(p23456, boxes, 7, valid=valid), boxes,
            valid)
        box_out = box_out.expand(*box_out.shape[:2], cfg.num_class - 1, 4)
        reg_w = torch.tensor(cfg.fastrcnn_bbox_reg_weights)
        dec = clip_boxes(decode_boxes(box_out / reg_w, boxes[:, :, None],
                                      cfg.bbox_decode_clip), (H, W))
        return p23456, dec, torch.softmax(label_out, -1), valid


def person_refs_valid(tm, dec, probs, valid):
    cfg = tm.config
    from object_detection_tracking_tpu_torch.ops.nms import nms
    pid = cfg.classname2id["Person"] - 1
    return nms(dec[:, :, pid], probs[:, :, pid + 1], cfg.so_person_topk,
               cfg.fastrcnn_nms_iou_thres, valid=valid)[1]


# --------------------------------------------------------------------------
# params


@pytest.mark.parametrize("association", [False, True])
def test_so_params_round_trip(association, tmp_path):
    """init_params draws JAX's SO leaves (names and shapes of JAX's
    init_params); params_from_jax and params_to_jax carry them bit for bit,
    and the native .npz with its small_objects/ root loads."""
    cfg = _cfg(use_so_association=association)
    ref = jax.eval_shape(jax_model(cfg).init_params, jax.random.PRNGKey(0))
    ref = {"/".join(str(k.key) for k in path): tuple(v.shape)
           for path, v in jax.tree_util.tree_leaves_with_path(ref)}
    tree = init_params(PortConfig(**dataclasses.asdict(cfg)))
    got = flat(tree)
    assert {k: v.shape for k, v in got.items()} == ref
    so = {k for k in got if k.startswith("small_objects/")}
    assert ("small_objects/person_object_relation/output_linear/W" in so) \
        == association
    assert {k for k in so if "classification" in k} == {
        f"small_objects/small_object_classification_c{i}/{p}"
        for i in (1, 2, 3) for p in ("W", "b")}
    rng = np.random.RandomState(0)
    tree = jax.tree.map(lambda v: rng.randn(*v.shape).astype(np.float32),
                        tree)
    tm = params_from_jax(tree, get_model(port_config(cfg)))
    back = flat(params_to_jax(tm))
    assert set(back) == set(got)
    for k in so:
        np.testing.assert_array_equal(back[k], flat(tree)[k], err_msg=k)
    path = str(tmp_path / "so.npz")
    save_npz_tree(path, tree)
    loaded = flat(load_npz_tree(path))
    for k in so:
        np.testing.assert_array_equal(loaded[k], flat(tree)[k], err_msg=k)


# --------------------------------------------------------------------------
# inference


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_so_outputs_match_jax(variant):
    """The forward's so_final_* against JAX's, every SO slot and person
    reference valid: valid slots and labels equal, boxes within 1e-3 px,
    probabilities within 1e-5 (the main forward's tolerances); the main
    detections are held too."""
    cfg = _cfg(**VARIANTS[variant])
    tree = option_tree(cfg)
    imgs = images()
    ref = {k: np.asarray(v) for k, v in jax.jit(jax_model(cfg).forward)(
        tree, imgs).items()}
    tm = params_from_jax(tree, get_model(port_config(cfg)))
    p23456, dec, probs, valid = so_inputs(tm, imgs)
    with torch.inference_mode():
        _, so_valid, _ = tm._so_core(p23456, dec, probs, valid)
        assert so_valid.all()
        if cfg.use_so_association:
            assert person_refs_valid(tm, dec, probs, valid).all()
        got = {k: v.numpy() for k, v in tm(torch.from_numpy(imgs)).items()}
    assert set(got) == set(ref)
    valid_out = ref["so_final_valid"]
    assert valid_out.any()
    if variant == "score_thres":    # the cut takes some, not all
        assert not valid_out.all()
    np.testing.assert_array_equal(got["so_final_valid"], valid_out)
    np.testing.assert_array_equal(got["so_final_labels"],
                                  ref["so_final_labels"])
    np.testing.assert_allclose(got["so_final_boxes"], ref["so_final_boxes"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["so_final_probs"], ref["so_final_probs"],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["final_valid"], ref["final_valid"])
    np.testing.assert_array_equal(got["final_labels"], ref["final_labels"])


def _valid_slots_only(orig):
    """JAX's person_object_relation on the valid slots alone: padded
    queries and references are the zero boxes that ``_so_core`` writes;
    padded queries, and every query of an image without a valid
    reference, get a zero residual. Eager only (numpy masks)."""
    def relation(p, feat, boxes, ref_boxes, ref_feat, group=16):
        feat, boxes = np.asarray(feat), np.asarray(boxes)
        ref_boxes, ref_feat = np.asarray(ref_boxes), np.asarray(ref_feat)
        q = (boxes != 0).any(-1)
        r = (ref_boxes != 0).any(-1)
        out = np.zeros_like(feat)
        if q.any() and r.any():
            out[q] = np.asarray(orig(p, feat[q], boxes[q], ref_boxes[r],
                                     ref_feat[r], group))
        return jnp.asarray(out)
    return relation


def test_padded_slots_follow_c18(monkeypatch):
    """Where NMS leaves padding among the SO slots and the references,
    JAX's SO logits are NaN and its SO head keeps no detection. The port
    is finite and keeps detections, and each valid slot's logits equal
    JAX's ``_so_core`` run with the relation over the valid slots alone
    (ROADMAP C18), on the same inputs."""
    cfg = _cfg(**PADDED)
    tree = option_tree(cfg)
    imgs = images()
    jm = jax_model(cfg)
    ref = jax.jit(jm.forward)(tree, imgs)
    assert int(np.asarray(ref["so_final_valid"]).sum()) == 0
    tm = params_from_jax(tree, get_model(port_config(cfg)))
    p23456, dec, probs, valid = so_inputs(tm, imgs)
    with torch.inference_mode():
        so_boxes, so_valid, so_logits = tm._so_core(p23456, dec, probs,
                                                    valid)
        got = tm(torch.from_numpy(imgs))
    assert not so_valid.all() and so_valid.any(-1).all()
    assert not person_refs_valid(tm, dec, probs, valid).all()
    assert torch.isfinite(so_logits).all()
    assert got["so_final_valid"].any()
    for k in SO_KEYS:
        assert torch.isfinite(got[k].float()).all(), k

    feats = [jnp.asarray(f.numpy()) for f in p23456[:4]]
    args = [jnp.asarray(t.numpy()) for t in (dec, probs, valid)]
    b = imgs.shape[0]
    plain = jm._so_core(tree, *[a[0] for a in args],
                        tuple(f[0] for f in feats))
    assert np.isnan(np.asarray(plain[2])).any()      # JAX's NaN
    monkeypatch.setattr(jrel, "person_object_relation",
                        _valid_slots_only(jrel.person_object_relation))
    for i in range(b):
        jb, jv, jl = (np.asarray(x) for x in jm._so_core(
            tree, *[a[i] for a in args], tuple(f[i] for f in feats)))
        np.testing.assert_array_equal(so_valid[i].numpy(), jv)
        np.testing.assert_allclose(so_boxes[i].numpy(), jb, atol=1e-4,
                                   rtol=0)
        close(so_logits[i].numpy()[jv], jl[jv], rel=1e-5)


def test_relation_without_valid_reference_is_zero():
    """An image with no valid person reference gets no relation message:
    its rows are exactly 0, the other image's rows are those of its own
    call, and the gradient is finite."""
    rng = np.random.RandomState(3)
    p = trel.Relation(64)
    feat = torch.from_numpy(rng.randn(2, 5, 64).astype(np.float32))
    feat.requires_grad_(True)
    xy = rng.uniform(0, 50, (2, 5, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(5, 30, (2, 5, 2))], -1).astype(np.float32))
    ref_boxes = boxes[:, :3].clone()
    ref_feat = feat[:, :3].detach().clone()
    ref_valid = torch.tensor([[False] * 3, [True, False, True]])
    valid = torch.tensor([[True] * 5, [True, True, False, True, True]])
    out = trel.person_object_relation(p, feat, boxes, ref_boxes, ref_feat,
                                      valid=valid, ref_valid=ref_valid)
    assert (out[0] == 0).all() and (out[1, 2] == 0).all()
    alone = trel.person_object_relation(
        p, feat[1:], boxes[1:], ref_boxes[1:], ref_feat[1:],
        valid=valid[1:], ref_valid=ref_valid[1:])
    torch.testing.assert_close(out[1], alone[0], rtol=0, atol=0)
    out.sum().backward()
    assert torch.isfinite(feat.grad).all()
    assert torch.isfinite(p.geo_emb.weight.grad).all()
