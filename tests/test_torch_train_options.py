"""One float32 training step under the detector's architecture options
(--use_gn --use_deformable --add_relation_nn --use_att_frcnn_head), the
port against JAX's ``forward_train`` and ``jax.grad`` on the CPU: R50 (the
deformable conv is bottleneck-only), 64x128 images, B=2, nothing frozen.

Both packages get one tree (torch_port_common.option_tree: offsets that
move the taps by about a pixel, GroupNorm off its identity) and the same
random draws (JAX's key tree rebuilt by ``forward_train_noise``). The
losses agree within 1e-5 relative and every gradient leaf follows
tests/test_torch_train_grads.py's rule (``_check_grads``); the new
modules (GroupNorm, the offset convs, the relation and attention
branches) must each take a gradient (not every leaf: no ROI of a 64x128
image reaches p4, so gn_p4's is 0 in both). Every sampled ROI row is a
real one here (asserted: each image has four valid gt boxes, which fill
its four foreground slots), so the relation's padded-row rule (ROADMAP
C14) leaves JAX's function unchanged; where a row is padding, JAX's
relation attends to its unit box and the port's does not, and
``test_padded_roi_rows_stay_out_of_the_relation`` holds the port to its
own rule there. JAX's gradient is jitted and computed once.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from object_detection_tracking_tpu.config import DetectorConfig  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu_torch.config import \
    DetectorConfig as PortConfig  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.params import params_from_jax  # noqa: E402
from torch_port_common import (TRAIN, flat, forward_train_noise,  # noqa: E402
                               grad_tree, option_tree, train_batch)
from test_torch_train_grads import _check_grads  # noqa: E402

H, W = 64, 128
OPTIONS = dict(use_gn=True, use_deformable=True, add_relation_nn=True,
               use_att_frcnn_head=True)
NEW_LEAF = ("fpn/gn_", "conv2_offset/", "fastrcnn/RM_r",
            "fastrcnn/attention/", "fastrcnn/att_trans/")
INVARIANT, NOISE_SHARE = "fastrcnn/attention/b", 1e-5


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


@pytest.fixture(scope="module")
def step():
    jcfg = DetectorConfig(**{**TRAIN, "resnet_depth": 50,
                             "short_edge_size": H, "max_size": W,
                             "freeze": -1, "fpn_frcnn_fc_head_dim": 256,
                             **OPTIONS})
    tcfg = PortConfig(**{**dataclasses.asdict(jcfg),
                         "roi_align_impl": "pallas",
                         "roi_align_train_impl": "pallas"})
    jm = jax_model(jcfg)
    tree = option_tree(jcfg)
    images, gt_boxes, gt_labels, gt_valid, _ = train_batch(h=H, w=W)
    gt_valid[:] = True    # four gt a image fill the four fg sample slots
    rng = jax.random.PRNGKey(3)
    noise = forward_train_noise(jm, rng, 2, H, W,
                                jcfg.rpn_train_post_nms_topk, 4)

    def loss_fn(p):
        losses = jm.forward_train(p, images, gt_boxes, gt_labels, gt_valid,
                                  rng)
        return losses["total_loss"], losses

    jgrads, jlosses = jax.jit(jax.grad(loss_fn, has_aux=True))(tree)
    tm = params_from_jax(tree, get_model(tcfg))
    sampled = []
    real = tm._apply_head

    def recording(roi_feats, boxes=None, valid=None):
        sampled.append(valid)
        return real(roi_feats, boxes, valid)

    tm._apply_head = recording
    tb = [torch.from_numpy(x) for x in (images, gt_boxes, gt_labels,
                                        gt_valid)]
    losses = tm.forward_train(*tb, noise=noise)
    losses["total_loss"].backward()
    return (jlosses, jax.tree.map(np.asarray, jgrads), losses,
            grad_tree(tm), sampled)


def test_losses_match_jax(step):
    jlosses, _, losses, _, sampled = step
    assert len(sampled) == 1 and sampled[0].all()   # no padded ROI row
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        assert losses[k].item() == pytest.approx(float(v), rel=1e-5), k


def _without(tree, path):
    """``tree`` without the leaf at slash-separated ``path``."""
    out = dict(tree)
    head, _, rest = path.partition("/")
    out[head] = _without(tree[head], rest) if rest else None
    if out[head] is None:
        del out[head]
    return out


def test_grads_match_jax(step):
    """Every leaf by _check_grads's rule but the attention conv's bias: it
    adds one constant to all 49 logits of a softmax, so its gradient is 0
    in exact arithmetic and both packages give it rounding noise; it must
    stay within NOISE_SHARE of the largest leaf gradient, as
    tests/test_torch_effdet_train.py holds such leaves."""
    _, jgrads, _, got, _ = step
    largest = max(np.abs(v).max() for v in flat(jgrads).values())
    for tree in (got, jgrads):
        noise = np.abs(flat(tree)[INVARIANT]).max()
        assert noise <= NOISE_SHARE * largest, noise / largest
    _check_grads(_without(got, INVARIANT), _without(jgrads, INVARIANT))
    for kind in NEW_LEAF:     # each new module takes a gradient
        assert max(np.abs(v).max() for k, v in flat(got).items()
                   if kind in k) > 0, kind


def test_padded_roi_rows_stay_out_of_the_relation(step):
    """With one gt padded (tests/test_train.py's batch), an image has a
    padded foreground slot. The port leaves that row out of the relation's
    attention (ROADMAP C14): the losses and every gradient are finite, and
    moving the padded row's box changes no loss."""
    jcfg = DetectorConfig(**{**TRAIN, "resnet_depth": 50,
                             "short_edge_size": H, "max_size": W,
                             "freeze": -1, "fpn_frcnn_fc_head_dim": 256,
                             **OPTIONS})
    tcfg = PortConfig(**{**dataclasses.asdict(jcfg),
                         "roi_align_impl": "pallas",
                         "roi_align_train_impl": "pallas"})
    tm = params_from_jax(option_tree(jcfg), get_model(tcfg))
    batch = [torch.from_numpy(x) for x in train_batch(h=H, w=W)[:4]]
    noise = forward_train_noise(jax_model(jcfg), jax.random.PRNGKey(3), 2,
                                H, W, jcfg.rpn_train_post_nms_topk, 4)
    seen = {}
    real = tm._apply_head

    def moving(roi_feats, boxes=None, valid=None):
        seen["valid"] = valid
        if seen.get("move"):
            boxes = torch.where(valid[..., None], boxes,
                                torch.tensor([3.0, 4.0, 30.0, 20.0]))
        return real(roi_feats, boxes, valid)

    tm._apply_head = moving
    losses = tm.forward_train(*batch, noise=noise)
    assert not seen["valid"].all()
    losses["total_loss"].backward()
    for k, v in losses.items():
        assert torch.isfinite(v), k
    for name, g in flat(grad_tree(tm)).items():
        assert np.isfinite(g).all(), name
    seen["move"] = True
    with torch.no_grad():
        moved = tm.forward_train(*batch, noise=noise)
    for k, v in losses.items():
        assert moved[k].item() == v.item(), k
