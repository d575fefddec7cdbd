"""The small-object heads in training (ROADMAP A8b), the port against the
JAX package on the CPU, in float32: ``so_label_loss`` and every gradient
leaf of a training step against JAX's ``forward_train`` and ``jax.grad``,
the box head's gradient through the pooled boxes included; ROIAlign's
gradient with respect to the boxes (kernel B1e's plain version) against
JAX's VJP of the exact gather; the trainable ROIAlign with boxes that
require grad; and two CPU steps of ``main.py train
--use_small_object_head``.

R18 at 64x128, ActEV's 16 classes (the SO classes Prop,
Push_Pulled_Object and Bike), a 256-wide box head, the stem and groups
0-1 frozen; each image's gt holds Person and small-object boxes. The
person association is on, and every SO slot and person reference of the
step is valid (asserted), so the port computes JAX's function; JAX's
gradient is jitted and computed once.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from object_detection_tracking_tpu.config import DetectorConfig  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu.ops.pallas.roi_align_pallas import \
    _xla_multilevel  # noqa: E402
from object_detection_tracking_tpu_torch.cli import main as M  # noqa: E402
from object_detection_tracking_tpu_torch.config import \
    DetectorConfig as PortConfig  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.ops import roi_align as RA  # noqa: E402
from object_detection_tracking_tpu_torch.params import (  # noqa: E402
    init_params, load_npz_tree, params_from_jax)
from test_torch_roi_align_bwd import (CASES, STRIDES, case_boxes,  # noqa: E402
                                      features)
from test_torch_train_grads import _check_grads  # noqa: E402
from torch_port_common import (TRAIN, close, flat, forward_train_noise,  # noqa: E402
                               grad_tree, option_tree, train_batch)

H, W = 64, 128


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module (as
    tests/test_torch_detector_options.py pins it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRAIN_SO = dict(num_class=16, short_edge_size=H, max_size=W, freeze=2,
                rpn_train_pre_nms_topk=64, rpn_train_post_nms_topk=64,
                fastrcnn_batch_per_im=32, result_per_im=4, so_person_topk=2,
                fpn_frcnn_fc_head_dim=256, use_small_object_head=True,
                use_so_association=True)
# Person, Prop, Push_Pulled_Object, Bike, Person, Prop
GT_LABELS = np.array([2, 12, 10, 13, 2, 12], np.int32)


@pytest.fixture(scope="module")
def train_step():
    jcfg = DetectorConfig(**{**TRAIN, **TRAIN_SO})
    tcfg = PortConfig(**{**dataclasses.asdict(jcfg),
                         "roi_align_impl": "pallas",
                         "roi_align_train_impl": "pallas"})
    jm = jax_model(jcfg)
    tree = option_tree(jcfg)
    imgs, gt_boxes, gt_labels, gt_valid, _ = train_batch(
        h=H, w=W, g=len(GT_LABELS), num_class=16)
    gt_labels[:] = GT_LABELS
    gt_valid[:] = True
    rng = jax.random.PRNGKey(3)
    noise = forward_train_noise(jm, rng, 2, H, W,
                                jcfg.rpn_train_post_nms_topk, len(GT_LABELS))

    def loss_fn(p):
        losses = jm.forward_train(p, imgs, gt_boxes, gt_labels, gt_valid,
                                  rng)
        return losses["total_loss"], losses

    jgrads, jlosses = jax.jit(jax.grad(loss_fn, has_aux=True))(tree)
    batch = [torch.from_numpy(x) for x in (imgs, gt_boxes, gt_labels,
                                           gt_valid)]

    def port(detach_boxes=False):
        tm = params_from_jax(tree, get_model(tcfg))
        core, seen = tm._so_core, []

        def spy(p23456, dec, probs, valid):
            out = core(p23456, dec.detach() if detach_boxes else dec,
                       probs, valid)
            seen.append(out[1])
            return out
        tm._so_core = spy
        losses = tm.forward_train(*batch, noise=noise)
        losses["total_loss"].backward()
        return losses, grad_tree(tm), seen

    return (jlosses, jax.tree.map(np.asarray, jgrads), port(), port(True))


def test_so_train_losses_match_jax(train_step):
    """so_label_loss and every other loss within 1e-5 relative of JAX's
    forward_train, every SO slot valid."""
    jlosses, _, (losses, _, seen), _ = train_step
    assert len(seen) == 1 and seen[0].all()
    assert set(losses) == set(jlosses) and "so_label_loss" in losses
    for k, v in jlosses.items():
        assert losses[k].item() == pytest.approx(float(v), rel=1e-5), k


def test_so_train_grads_match_jax(train_step):
    """Every gradient leaf by tests/test_torch_train_grads.py's rule,
    the SO classifiers, the person relation and the box head's included;
    each SO leaf takes a gradient."""
    _, jgrads, (_, got, _), _ = train_step
    _check_grads(got, jgrads)
    for k, v in flat(got).items():
        if k.startswith("small_objects/") and not k.endswith("/b"):
            assert np.abs(v).max() > 0, k


def test_so_loss_reaches_the_box_head_through_the_boxes(train_step):
    """The SO loss's gradient reaches the box head's box deltas through
    the pooled boxes (ROIAlign's box gradient) and the relation's
    geometry: cutting it there moves the box layer's gradient, and only
    the full gradient matches JAX's."""
    _, jgrads, (_, got, _), (_, cut, _) = train_step
    name = "fastrcnn/outputs/box/W"
    ref = flat(jgrads)[name]
    full, detached = flat(got)[name], flat(cut)[name]
    scale = np.abs(ref).max()
    assert np.abs(full - ref).max() <= 1e-3 * scale
    assert np.abs(detached - ref).max() > 1e-2 * scale


@pytest.mark.parametrize("case", CASES)
def test_plain_box_grad_matches_jax_vjp(case):
    """ROIAlign's gradient with respect to the boxes, the plain version
    (kernel B1e's spec) against JAX's VJP of the exact gather, on
    tests/test_torch_roi_align_bwd.py's boxes: random ones, aspect-5 ones
    over the image's edge, zero-area ones, samples on the last row and
    column (both neighbours one pixel), and boxes outside the image (no
    gradient)."""
    pool = 7
    feats = features()
    boxes = case_boxes(case)
    g = np.random.RandomState(4).randn(*boxes.shape[:2], pool, pool,
                                       feats[0].shape[-1]).astype(np.float32)
    _, vjp = jax.vjp(lambda b: _xla_multilevel(
        tuple(jnp.asarray(f.numpy()) for f in feats), b, STRIDES, pool),
        jnp.asarray(boxes))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    got = RA.multilevel_roi_align_box_vjp(feats, torch.from_numpy(boxes),
                                          STRIDES, pool,
                                          torch.from_numpy(g)).numpy()
    assert got.shape == boxes.shape and np.isfinite(got).all()
    if case == "outside":
        assert not ref.any() and not got.any()
    else:
        assert np.abs(ref).max() > 0
        close(got, ref, rel=1e-5)
    # the wrapper takes the plain version for CPU tensors
    wrapped = RA.multilevel_roi_align_box_grad_cuda(
        feats, torch.from_numpy(boxes), STRIDES, pool, torch.from_numpy(g))
    np.testing.assert_array_equal(wrapped.numpy(), got)


def test_trainable_roi_align_gives_the_boxes_their_gradient():
    """multilevel_roi_align_trainable (the CPU path of kernels B1, B1b and
    B1e) takes boxes that require grad and gives them the plain version's
    gradient, beside the features'."""
    feats = [f.requires_grad_(True) for f in features()]
    boxes = torch.from_numpy(case_boxes("random")).requires_grad_(True)
    out = RA.multilevel_roi_align_trainable(feats, boxes, STRIDES, 7)
    g = torch.randn_like(out)
    out.backward(g)
    ref = RA.multilevel_roi_align_box_vjp(feats, boxes, STRIDES, 7, g)
    torch.testing.assert_close(boxes.grad, ref, rtol=0, atol=0)
    fref = RA.multilevel_roi_align_vjp(feats, boxes, STRIDES, 7, g)
    for f, r in zip(feats, fref):
        torch.testing.assert_close(f.grad, r, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the train CLI


class SOBatches:
    """One batch with Person and small-object gt, ``steps`` times
    (``batches`` as DetectionTrainDataset has it)."""

    def __init__(self, steps):
        imgs, boxes, labels, valid, _ = train_batch(
            h=H, w=W, g=len(GT_LABELS), num_class=16)
        labels[:] = GT_LABELS
        self.batch = (imgs, boxes, labels, valid)
        self.num_samples = 2 * steps

    def batches(self, epochs=1):
        for _ in range(self.num_samples // 2 * epochs):
            yield self.batch


def test_train_cli_with_small_object_head(tmp_path):
    """Two CPU steps of ``main.py train --use_small_object_head`` (no
    other flag turns the heads on, as in JAX): the losses hold
    so_label_loss and are finite, the SO leaves move, and final.npz holds
    them and loads into a model with the heads."""
    args = M.get_args([
        "train", "--use_small_object_head", "--outbasepath",
        str(tmp_path), "--im_batch_size", "2", "--num_step", "2",
        "--resnet18", "--short_edge_size", str(H), "--max_size", str(W),
        "--rpn_train_post_nms_topk", "32", "--rpn_batch_size", "32",
        "--frcnn_batch_size", "16", "--result_per_im", "4",
        "--version", "2", "--warmup_steps", "0", "--init_lr", "0.01",
        "--device", "cpu"])
    cfg = M.build_config(args, True, torch.device("cpu"))
    assert cfg.use_small_object_head and not cfg.use_so_association
    seen = []
    real = M.Trainer.step

    def step(self, *a, **k):
        losses = real(self, *a, **k)
        seen.append({n: float(v) for n, v in losses.items()})
        return losses
    M.Trainer.step = step
    try:
        res = M.mode_train(args, dataset=SOBatches(2))
    finally:
        M.Trainer.step = real
    assert res["step"] == 2 and len(seen) == 2
    for losses in seen:
        assert "so_label_loss" in losses
        assert all(np.isfinite(v) for v in losses.values())
    init = flat(init_params(cfg, seed=0))
    tree = flat(load_npz_tree(str(tmp_path / "odt" / "final.npz")))
    so = [k for k in tree if k.startswith("small_objects/")]
    assert len(so) == 6
    assert any(not np.array_equal(tree[k], init[k]) for k in so)
    params_from_jax(load_npz_tree(str(tmp_path / "odt" / "final.npz")),
                    get_model(dataclasses.replace(cfg, is_train=False)))
