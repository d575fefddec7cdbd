"""EfficientDet training in the port against the JAX package, on the CPU:
``batch_bn``, ``encode_effdet_boxes``, ``effdet_anchor_targets``,
``forward_train`` (losses and every gradient leaf), three Adam steps,
``calibrate_bn`` and the calibrated forward, at efficientdet-test (128 px,
32 filters, B0 backbone), ``num_class=4``, float32, B=2. The params are
tests/torch_port_common.py's ``effdet_params`` (the port's JAX-free init
with random fusion weights, gamma and beta), carried across by
``params_from_jax``. JAX runs jitted, each of its results computed once
per module; its three Adam steps apply its Trainer's optimizer chain
(``Trainer.tx``) to the jitted gradient, the body of
``Trainer.make_step_fn``, which saves a second compile of the whole step.
tests/test_torch_effdet_train_cli.py drives the port's train loop.

Tolerances. ``batch_bn``: values and the VJP within 1e-6 of their largest
magnitude in float32, and within 1 bf16 ulp in bfloat16. Box targets
within 1e-6 of their largest magnitude; labels and fg equal. Losses within
1e-5 relative. Gradients, per leaf, tests/test_torch_train_grads.py's rule
(exactly zero where JAX's is, else within 2e-2 of the leaf's max with
cosine >= 0.9999, the median leaf within 1e-3). Adam steps: losses within
1e-4 relative. Calibrated statistics within 1e-4 of each leaf's largest
magnitude, the feature maps' tolerance of tests/test_torch_efficientdet.py:
they are moments of maps that went through ~50 batch-BN layers, which
agree with JAX's to a few 1e-5 (measured worst 6.8e-5, at a P7 head BN
over two batches of 8; 3.5e-4 with batches of 4, where P7 gives each
channel 4 samples). Each package's calibrated model, end to end:
detections and labels equal, boxes within 2e-2 px, probabilities and
embeddings within 1e-3 of their largest magnitude (measured 5.6e-3 px,
9.9e-5 and 1.5e-4 with 1, 2 and 8 torch threads: the statistics' few
1e-5, through the forward; on one and the same calibrated tree the two
forwards agree to 1.03e-3 px, 7.0e-6 and 1.1e-5).

B=4: at B=2 the P7 maps are 1x1, so each BN channel there has two
samples; random images give two nearly equal ones and E[x^2] - mean^2
cancels (mean^2/var up to 8.6e4), where JAX's own jitted and eager
statistics part by 2.6e-3. At B=4 the worst ratio is 121."""

import contextlib
import io
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from object_detection_tracking_tpu.config import DetectorConfig  # noqa: E402
from object_detection_tracking_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from object_detection_tracking_tpu.models.efficientdet import \
    EfficientDet as JED  # noqa: E402
from object_detection_tracking_tpu.models.efficientdet.anchors import \
    encode_effdet_boxes as jax_encode  # noqa: E402
from object_detection_tracking_tpu.ops.norm import \
    batch_bn as jax_batch_bn  # noqa: E402
from object_detection_tracking_tpu.train import Trainer as JTrainer  # noqa: E402
from object_detection_tracking_tpu.train.targets import \
    effdet_anchor_targets as jax_targets  # noqa: E402
from object_detection_tracking_tpu_torch.config import TrainConfig  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.models.efficientdet import (  # noqa: E402
    effdet_anchors, encode_effdet_boxes)
from object_detection_tracking_tpu_torch.ops.norm import (  # noqa: E402
    FrozenBN, batch_bn)
from object_detection_tracking_tpu_torch.params import (  # noqa: E402
    _get, _leaves, _to_torch, params_from_jax, params_to_jax)
from object_detection_tracking_tpu_torch.train import Trainer  # noqa: E402
from object_detection_tracking_tpu_torch.train.targets import \
    effdet_anchor_targets  # noqa: E402
from test_torch_efficientdet import port_forward  # noqa: E402
from test_torch_train_grads import _check_grads  # noqa: E402
from torch_port_common import (close, effdet_params, flat,  # noqa: E402
                               grad_tree, port_config)

H, W, G = 112, 128, 5
JCFG = DetectorConfig(model="efficientdet",
                      efficientdet_name="efficientdet-test", num_class=4,
                      compute_dtype="float32", result_per_im=10,
                      roi_align_impl="xla", is_train=True)
ADAM = dict(optimizer="adam", init_lr=3e-3, warmup_steps=0, total_steps=100,
            lr_schedule="constant", wd=1e-4, clip_gradient_norm=10.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module: its small tensors gain
    nothing from more, and among the suite's parallel workers a process's
    many threads wait for each other at every op (the 25-step train of
    test_torch_effdet_train_cli.py took 387 s beside three busy workers,
    10 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(seed, b=4, h=H, w=W):
    return np.random.RandomState(seed).randint(
        0, 255, (b, h, w, 3)).astype(np.uint8)


def gt_batch(seed=0, b=4, g=G):
    """Random gt boxes inside H x W, labels 1..3, padded rows (zeros) at
    the end of each image's list."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, [W - 20, H - 20], (b, g, 2))
    wh = rng.uniform(8, 60, (b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [W, H])], -1).astype(
        np.float32)
    labels = rng.randint(1, 4, (b, g)).astype(np.int32)
    valid = np.ones((b, g), bool)
    valid[0, -2:] = False
    valid[-1, -1] = False
    boxes[~valid] = 0.0
    labels[~valid] = 0
    return boxes, labels, valid


@pytest.fixture(scope="module")
def setup():
    """(JAX model, port model, JAX tree, numpy batch)."""
    imgs = images(1)
    tm, tree = effdet_params(JCFG, imgs)
    return JED(JCFG), tm, tree, (imgs,) + gt_batch()


@pytest.fixture(scope="module")
def jax_grad(setup):
    """params -> (grads, losses) of JAX's forward_train on the batch,
    jitted once."""
    jm, _, _, (imgs, gtb, gtl, gtv) = setup

    def loss_fn(p):
        losses = jm.forward_train(p, imgs, gtb, gtl, gtv,
                                  jax.random.PRNGKey(0))
        return losses["total_loss"], losses
    return jax.jit(jax.grad(loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_first(setup, jax_grad):
    grads, losses = jax_grad(setup[2])
    return (jax.tree.map(np.asarray, grads),
            {k: float(v) for k, v in losses.items()})


def torch_batch(batch):
    return [torch.from_numpy(x) for x in batch]


# --------------------------------------------------------------------------
# batch_bn and encode


def bf16_ulp(x):
    """The bf16 ulp at each |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_bn_matches_jax(dtype):
    """Values (and in float32 the VJP to x, gamma and beta of a random
    cotangent) on NCHW input with a non-zero mean."""
    rng = np.random.RandomState(0)
    x = (0.5 + 1.3 * rng.randn(2, 8, 6, 5)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    beta = rng.randn(8).astype(np.float32)
    ct = rng.randn(*x.shape).astype(np.float32)
    x_nhwc = x.transpose(0, 2, 3, 1)

    def jfn(x_, g_, b_):
        return jax_batch_bn({"gamma": g_, "beta": b_}, x_)
    bn = FrozenBN(8)
    with torch.no_grad():
        bn.gamma.copy_(torch.from_numpy(gamma))
        bn.beta.copy_(torch.from_numpy(beta))
    if dtype == "bfloat16":
        ref = np.asarray(jfn(jnp.asarray(x_nhwc, jnp.bfloat16), gamma, beta)
                         .astype(jnp.float32)).transpose(0, 3, 1, 2)
        got = batch_bn(bn, torch.from_numpy(x).bfloat16()).float().numpy()
        assert np.all(np.abs(got - ref) <= bf16_ulp(ref)), \
            np.abs(got - ref).max()
        return
    ref, vjp = jax.vjp(jfn, x_nhwc, gamma, beta)
    ref_dx, ref_dg, ref_db = vjp(jnp.asarray(ct.transpose(0, 2, 3, 1)))
    bn.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = batch_bn(bn, xt)
    got.backward(torch.from_numpy(ct))
    close(got.detach().numpy(), np.asarray(ref).transpose(0, 3, 1, 2), 1e-6)
    close(xt.grad.numpy(), np.asarray(ref_dx).transpose(0, 3, 1, 2), 1e-6)
    close(bn.gamma.grad.numpy(), ref_dg, 1e-6)
    close(bn.beta.grad.numpy(), ref_db, 1e-6)
    assert bn.mean.grad is None and bn.variance.grad is None


def test_encode_effdet_boxes_matches_jax():
    rng = np.random.RandomState(3)
    xy = rng.uniform(0, 400, (500, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(4, 300, (500, 2))],
                             -1).astype(np.float32)
    xy = rng.uniform(0, 400, (500, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 300, (500, 2))],
                           -1).astype(np.float32)
    boxes[:20, 2:] = boxes[:20, :2]           # zero width and height
    ref = np.asarray(jax_encode(jnp.asarray(boxes), jnp.asarray(anchors)))
    got = encode_effdet_boxes(torch.from_numpy(boxes),
                              torch.from_numpy(anchors)).numpy()
    close(got, ref, 1e-6)


# --------------------------------------------------------------------------
# targets


def _flat_anchors(size):
    return np.concatenate([a.reshape(-1, 4) for a in effdet_anchors(
        (size, size), anchor_scale=4.0)])


def _case(name):
    """(anchors [N, 4], gt boxes [B, G, 4], labels [B, G], valid [B, G])."""
    f32 = np.float32
    if name == "jax_rules":       # tests/test_efficientdet.py:193-214
        return (np.array([[0, 0, 10, 10], [100, 100, 110, 110],
                          [200, 200, 210, 210]], f32),
                np.array([[[0, 0, 10, 10], [100, 100, 140, 160],
                           [0, 0, 0, 0]]], f32),
                np.array([[2, 3, 1]], np.int32),
                np.array([[True, True, False]]))
    if name == "shared_best_anchor":
        # both gts' best anchor is 0, both below 0.5: the later row's write
        # wins the force match there, though row 0 has the higher IoU
        return (np.array([[0, 0, 10, 10], [50, 50, 60, 60],
                          [200, 200, 210, 210]], f32),
                np.array([[[0, 0, 25, 25], [0, 0, 30, 30]]], f32),
                np.array([[1, 3]], np.int32),
                np.array([[True, True]]))
    if name == "best_anchor_0_then_padding":
        # image 0's valid gt has its best anchor (IoU 0.39) at 0; the
        # padded rows (IoU -1 columns, so best anchor 0 too) write -1 there
        # after it, and the gt loses its forced match; image 1's keeps its
        # anchor 1
        return (np.array([[0, 0, 10, 10], [60, 60, 70, 70],
                          [30, 30, 50, 50]], f32),
                np.array([[[0, 0, 16, 16], [5, 5, 9, 9], [0, 0, 0, 0]],
                          [[60, 60, 90, 90], [0, 0, 0, 0], [0, 0, 0, 0]]],
                         f32),
                np.array([[2, 1, 0], [3, 0, 0]], np.int32),
                np.array([[True, False, False], [True, False, False]]))
    if name == "all_padded":
        anchors = _flat_anchors(128)
        return (anchors, np.zeros((2, 4, 4), f32), np.zeros((2, 4), np.int32),
                np.zeros((2, 4), bool))
    assert name == "random"
    boxes, labels, valid = gt_batch(5, b=3, g=8)
    boxes[2, :4] = boxes[2, 0]                # duplicate gts
    return _flat_anchors(128), boxes, labels, valid


@pytest.mark.parametrize("name", ["jax_rules", "shared_best_anchor",
                                  "best_anchor_0_then_padding",
                                  "all_padded", "random"])
def test_effdet_anchor_targets_match_jax(name):
    anchors, boxes, labels, valid = _case(name)
    # vmapped over images, as forward_train runs it
    ref_cls, ref_box, ref_fg = (np.asarray(r) for r in jax.jit(jax.vmap(
        jax_targets, in_axes=(None, 0, 0, 0)))(anchors, boxes, labels,
                                                valid))
    cls_t, box_t, fg = effdet_anchor_targets(*torch_batch(
        (anchors, boxes, labels, valid)))
    assert cls_t.dtype == torch.int32 and fg.dtype == torch.bool
    np.testing.assert_array_equal(fg.numpy(), ref_fg)
    np.testing.assert_array_equal(cls_t.numpy(), ref_cls)
    close(box_t.numpy(), ref_box, 1e-6)
    if name == "jax_rules":
        assert ref_fg[0].tolist() == [True, True, False]
    if name == "shared_best_anchor":
        assert ref_cls[0, 0] == 3          # the last row's write
    if name == "best_anchor_0_then_padding":
        assert ref_fg.tolist() == [[False] * 3, [False, True, False]]
    if name == "all_padded":
        assert not ref_fg.any() and not ref_box.any()
    if name == "random":
        assert ref_fg.sum() > 20


# --------------------------------------------------------------------------
# forward_train, Trainer


# leaves whose gradient vanishes in exact arithmetic: batch-statistics BN
# removes any per-channel constant added before it, so the bias of a conv
# that feeds a BN, and the beta of a BN whose map reaches BNs only through
# 1x1 convs (each MBConv's project BN: the stream goes on into expand
# convs, cell 0's resample convs and P6's; the last cell's P7 node, a 1x1
# map at 128 px, whose heads' first depthwise conv sees only its centre
# tap), take float32 rounding noise in both packages, up to 1.1e-6 of the
# largest leaf here in JAX, with no agreement to check
_INVARIANT = re.compile(
    r"(^resample/p6|/resample_\d+_\d+_\d+|/fnode\d+/pw|_net/conv\d+/pw)/b$"
    r"|^backbone/group\d+/block\d+/project/bn/beta$"
    r"|^fpn_cells/cell_1/fnode7/bn/beta$")
NOISE_SHARE = 1e-5


def check_grads(got, ref):
    """tests/test_torch_train_grads.py's rule on every leaf but the
    invariant ones, which must lie within NOISE_SHARE of the largest leaf
    gradient in both. Returns the per-leaf shares."""
    got, ref = flat(got), flat(ref)
    assert set(got) == set(ref)
    top = max(np.abs(r).max() for r in ref.values())
    invariant = [k for k in ref if _INVARIANT.search(k)]
    assert len(invariant) == 43, len(invariant)
    for k in invariant:
        assert np.abs(ref.pop(k)).max() <= NOISE_SHARE * top, k
        assert np.abs(got.pop(k)).max() <= NOISE_SHARE * top, k
    return _check_grads(got, ref)


def test_forward_train_losses_and_grads_match_jax(setup, jax_first):
    _, tm, _, batch = setup
    jgrads, jlosses = jax_first
    tm.zero_grad(set_to_none=True)
    losses = tm.forward_train(*torch_batch(batch))
    assert set(losses) == set(jlosses) == {
        "total_loss", "effdet_cls_loss", "effdet_box_loss",
        "num_pos_anchors"}
    for k, v in jlosses.items():
        assert losses[k].item() == pytest.approx(v, rel=1e-5), k
    assert jlosses["num_pos_anchors"] > 1
    losses["total_loss"].backward()
    got = grad_tree(tm)
    shares = check_grads(got, jgrads)
    worst = max(shares, key=shares.get)
    print(f"worst gradient leaf {worst}: {shares[worst]:.3g} of its max")
    # batch-statistics BN reads no stored statistics
    for name, g in flat(got).items():
        if name.endswith(("/mean", "/variance")):
            assert not g.any(), name


def decay_groups(tree):
    """(pack, unpack): a param tree <-> {"W": every leaf under a "W" key,
    raveled and concatenated, "rest": the other leaves}. JAX's optimizer
    chain is elementwise but for the global norm of its clip, and its
    decay mask picks "W" keys, so on the two groups it does what it does
    leaf by leaf, without compiling ~560 leaves' updates (eager, that takes
    ~70 s here)."""
    shapes = flat(tree)
    names = {"W": [n for n in shapes if "W" in n.split("/")]}
    names["rest"] = [n for n in shapes if n not in names["W"]]

    def pack(t):
        f = flat(t)
        return {g: np.concatenate([f[n].ravel() for n in ns])
                for g, ns in names.items()}

    def unpack(groups):
        out = {}
        for g, ns in names.items():
            v = np.asarray(groups[g])
            off = 0
            for n in ns:
                size = shapes[n].size
                node = out
                for k in n.split("/")[:-1]:
                    node = node.setdefault(k, {})
                node[n.split("/")[-1]] = v[off:off + size].reshape(
                    shapes[n].shape)
                off += size
        return out
    return pack, unpack


def test_trainer_adam_steps_match_jax(setup, jax_grad):
    """Three steps of the port's Trainer (Adam, weight decay on "W",
    global clip) against JAX's Trainer's optimizer chain (``decay_groups``):
    at each step the losses, the port's own gradient held to JAX's by
    ``check_grads``, then the port's update taken from JAX's gradient.
    Adam's first steps move each element by about +-lr whatever its
    gradient's size, so an element whose gradient lies within float32
    noise of zero (1,228 of 3.9 M here: the invariant leaves and a few of
    the large kernels) steps either way, and with each package's own
    gradient the losses part by 6.3e-3 relative at the third step; on the
    same gradient they agree as the forward does."""
    jm, _, tree, batch = setup
    tx = JTrainer(jm, JTrainConfig(**ADAM)).tx
    pack, unpack = decay_groups(tree)
    params = pack(tree)
    opt = tx.init(params)
    tm = params_from_jax(tree, get_model(port_config(JCFG)))
    trainer = Trainer(tm, TrainConfig(**ADAM))
    ref, got = [], []
    for _ in range(3):
        grads, losses = jax_grad(unpack(params))
        ref.append(float(losses["total_loss"]))
        grads = jax.tree.map(np.asarray, grads)
        updates, opt = tx.update(pack(grads), opt, params)
        params = optax.apply_updates(params, updates)
        step_losses = trainer.losses(*torch_batch(batch))
        got.append(step_losses["total_loss"].item())
        trainer.backward(step_losses)
        check_grads(grad_tree(tm), grads)
        with torch.no_grad():        # the update from JAX's gradient
            for path, t, kind in _leaves(tm):
                t.grad.copy_(_to_torch(_get(grads, path), kind))
        trainer.apply_gradients()
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert len(set(ref)) == 3


# --------------------------------------------------------------------------
# calibrate_bn


def test_calibrate_bn_and_calibrated_forward_match_jax(setup):
    jm, _, tree, _ = setup
    cal_batches = [images(1, b=8), images(9, b=8)]
    jtree = jax.tree.map(np.array, tree)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jm.calibrate_bn(jtree, iter(cal_batches))
        tm = params_from_jax(tree, get_model(port_config(JCFG)))
        assert tm.calibrate_bn(iter(cal_batches)) is tm
    lines = out.getvalue().splitlines()
    assert len(lines) == 2 and lines[0] == lines[1], lines
    n_bn = sum(isinstance(m, FrozenBN) for m in tm.modules())
    assert lines[0] == f"calibrated {n_bn} BN sites over 2 batches"
    got, ref, before = (flat(params_to_jax(tm)), flat(jtree), flat(tree))
    n_stats = 0
    for k, r in ref.items():
        if k.endswith(("/mean", "/variance")):
            close(got[k], r, 1e-4)
            assert not np.array_equal(r, before[k]), k
            n_stats += 1
        else:
            np.testing.assert_array_equal(got[k], r, err_msg=k)
    assert n_stats == 2 * n_bn
    # each package's calibrated model, end to end
    x = images(4, b=2).astype(np.float32)
    jref = {k: np.asarray(v) for k, v in jax.jit(jm.forward)(
        jax.tree.map(jnp.asarray, jtree), x).items()}
    got = port_forward(tm, x)
    valid = jref["final_valid"]
    assert valid.sum() >= 10
    np.testing.assert_array_equal(got["final_valid"], valid)
    np.testing.assert_array_equal(got["final_labels"], jref["final_labels"])
    np.testing.assert_allclose(got["final_boxes"], jref["final_boxes"],
                               atol=2e-2, rtol=0)
    close(got["final_probs"], jref["final_probs"], 1e-3)
    close(got["pooled_box_feat"], jref["pooled_box_feat"], 1e-3)
