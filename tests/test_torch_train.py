"""The port's training pieces against the JAX package on the CPU: losses,
target assignment on JAX's own random draws, encode_boxes, the LR
schedules, each optimizer against optax, and the trainable ROIAlign's
backward against ``jax.vjp`` of the exact gather.

Tolerances: float32 values from the same formulas in another order agree
to 1e-5 of the reference's largest magnitude (``close``); integer labels,
masks and sampled indices are equal; optimizer states after 3 steps agree
to 1e-5 of the largest magnitude (optax computes its schedule and bias
corrections in float32, the port in float64 before the update)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from object_detection_tracking_tpu.config import TrainConfig as JTrainConfig
from object_detection_tracking_tpu.ops import boxes as jboxes
from object_detection_tracking_tpu.ops.pallas.roi_align_pallas import \
    _xla_multilevel
from object_detection_tracking_tpu.train import losses as jl
from object_detection_tracking_tpu.train import targets as jt
from object_detection_tracking_tpu.train import trainer as jtrainer
from object_detection_tracking_tpu_torch.config import TrainConfig
from object_detection_tracking_tpu_torch.models import get_model
from object_detection_tracking_tpu_torch.ops import boxes as tboxes
from object_detection_tracking_tpu_torch.ops import roi_align as RA
from object_detection_tracking_tpu_torch.train import Optimizer
from object_detection_tracking_tpu_torch.train import losses as tl
from object_detection_tracking_tpu_torch.train import targets as tt
from object_detection_tracking_tpu_torch.train import make_lr_schedule
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import close, jax_draws, train_configs

T = torch.from_numpy


def _boxes(rng, shape, lo=0.0, hi=60.0, min_wh=2.0, max_wh=30.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(min_wh, max_wh, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_elementwise_losses_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 7) * 3).astype(np.float32)
    x[0, :3] = 0.0
    y = (rng.rand(6, 7) > 0.5).astype(np.float32)
    lab = rng.randint(0, 7, (6,)).astype(np.int64)
    close(tl.huber(T(x), 1.0 / 9), jl.huber(jnp.asarray(x), 1.0 / 9))
    close(tl.sigmoid_ce(T(x), T(y)), jl.sigmoid_ce(jnp.asarray(x),
                                                   jnp.asarray(y)))
    close(tl.softmax_ce(T(x), T(lab)),
          jl.softmax_ce(jnp.asarray(x), jnp.asarray(lab)))
    close(tl.focal_loss(T(x), T(y)), jl.focal_loss(jnp.asarray(x),
                                                   jnp.asarray(y)))


def test_encode_boxes_matches_jax_and_inverts_decode():
    rng = np.random.RandomState(1)
    a = _boxes(rng, (5, 9))
    t = _boxes(rng, (5, 9))
    got = tboxes.encode_boxes(T(t), T(a))
    close(got, jboxes.encode_boxes(jnp.asarray(t), jnp.asarray(a)))
    back = tboxes.decode_boxes(got, T(a), 10.0)
    np.testing.assert_allclose(back.numpy(), t, atol=1e-4)


@pytest.mark.parametrize("use_focal", [False, True])
def test_rpn_and_fastrcnn_losses_match_jax(use_focal):
    rng = np.random.RandomState(2)
    b, n, s, c = 2, 50, 12, 5
    labels = rng.randint(-1, 2, (b, n)).astype(np.int32)
    labels[1] = -1                              # nothing valid: loss 0
    anchors = _boxes(rng, (n,))
    tboxes_ = _boxes(rng, (b, n))
    ll = rng.randn(b, n).astype(np.float32)
    bl = rng.randn(b, n, 4).astype(np.float32) * 0.3
    got = tl.rpn_losses(T(labels), T(tboxes_), T(anchors), T(ll), T(bl), 32,
                        use_focal=use_focal)
    ref = jax.vmap(lambda *a: jl.rpn_losses(*a, rpn_batch_per_im=32,
                                            use_focal=use_focal),
                   in_axes=(0, 0, None, 0, 0))(
        jnp.asarray(labels), jnp.asarray(tboxes_), jnp.asarray(anchors),
        jnp.asarray(ll), jnp.asarray(bl))
    for k in ref:
        close(got[k], ref[k])
    for nb in (1, c - 1):                       # agnostic and per-class
        flab = rng.randint(0, c, (b, s)).astype(np.int32)
        logits = rng.randn(b, s, c).astype(np.float32)
        enc = rng.randn(b, s, 4).astype(np.float32)
        boxl = rng.randn(b, s, nb, 4).astype(np.float32)
        valid = rng.rand(b, s) > 0.2
        fg = valid & (flab > 0)
        got = tl.fastrcnn_losses(T(flab), T(logits), T(enc), T(boxl),
                                 T(valid), T(fg), use_focal=use_focal)
        ref = jax.vmap(lambda *a: jl.fastrcnn_losses(
            *a, use_focal=use_focal))(
            jnp.asarray(flab), jnp.asarray(logits), jnp.asarray(enc),
            jnp.asarray(boxl), jnp.asarray(valid), jnp.asarray(fg))
        for k in ref:
            close(got[k], ref[k])


def test_crop_mask_and_mask_loss_match_jax():
    rng = np.random.RandomState(3)
    b, s, ms = 2, 6, 28
    masks = (rng.rand(b, s, ms, ms) > 0.5).astype(np.float32)
    gt = _boxes(rng, (b, s), max_wh=40.0)
    gt[0, 0] = [10.0, 20.0, 66.0, 76.0]
    roi = gt + rng.uniform(-6, 6, gt.shape).astype(np.float32)
    roi[0, 0] = gt[0, 0]                         # identity resample
    roi[0, 1] = [gt[0, 1, 2], gt[0, 1, 1], gt[0, 1, 2] + 20, gt[0, 1, 3]]
    got = tl.crop_mask_to_roi(T(masks), T(gt), T(roi))
    ref = jax.vmap(jax.vmap(jl.crop_mask_to_roi))(
        jnp.asarray(masks), jnp.asarray(gt), jnp.asarray(roi))
    close(got, ref)
    np.testing.assert_array_equal(got.numpy() >= 0.5, np.asarray(ref) >= 0.5)
    np.testing.assert_allclose(got[0, 0].numpy(), masks[0, 0], atol=1e-5)
    assert got[0, 1].max() == 0                 # roi beside the gt box
    logits = rng.randn(b, s, 28, 28, 3).astype(np.float32) * 2
    labels = rng.randint(1, 4, (b, s)).astype(np.int32)
    fg = rng.rand(b, s) > 0.4
    fg[1] = False                               # no fg rows: loss 0
    tgt = (got >= 0.5).float()
    close(tl.maskrcnn_loss(T(logits), T(labels), T(fg), tgt),
          jax.vmap(jl.maskrcnn_loss)(jnp.asarray(logits), jnp.asarray(labels),
                                     jnp.asarray(fg), jnp.asarray(tgt)))


def test_anchor_targets_match_jax_on_its_draws():
    _, _, fields, _ = get_model(train_configs()[1])._static_geometry(48, 64)
    anchors = torch.cat(fields).numpy()
    rng = np.random.RandomState(4)
    b, g = 3, 5
    gt = _boxes(rng, (b, g), hi=40.0, min_wh=6.0, max_wh=24.0)
    gt[1, 2] = gt[1, 1]                          # duplicate gt
    valid = np.ones((b, g), bool)
    valid[2, 3:] = False
    keys = jax.random.split(jax.random.PRNGKey(5), b)
    u_fg, u_bg = jax_draws(keys, anchors.shape[0])
    got_l, got_t = tt.anchor_targets(T(anchors), T(gt), T(valid), (48, 64),
                                     32, 0.5, 0.7, 0.3, u_fg=u_fg, u_bg=u_bg)
    ref_l, ref_t = jax.vmap(lambda k, gb, gv: jt.anchor_targets(
        k, jnp.asarray(anchors), gb, gv, (48, 64), 32, 0.5, 0.7, 0.3))(
        keys, jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    assert (got_l == 1).any() and (got_l == 0).any()
    # a generator instead of draws: the same rules, the caps hold
    lab, _ = tt.anchor_targets(T(anchors), T(gt), T(valid), (48, 64), 32,
                               generator=torch.Generator().manual_seed(0))
    assert ((lab == 1).sum(1) <= 16).all() and ((lab >= 0).sum(1) <= 32).all()


def test_sample_fastrcnn_targets_match_jax_on_its_draws():
    rng = np.random.RandomState(6)
    b, k, g = 2, 20, 4
    gt = _boxes(rng, (b, g), hi=40.0, min_wh=6.0, max_wh=24.0)
    props = np.concatenate(
        [gt[:, :, None] + rng.uniform(-3, 3, (b, g, 3, 4)),
         _boxes(rng, (b, g, 2))], 2).reshape(b, -1, 4)[:, :k].astype(
        np.float32)
    pvalid = rng.rand(b, k) > 0.2
    labels = rng.randint(1, 4, (b, g)).astype(np.int32)
    gvalid = np.ones((b, g), bool)
    gvalid[1, -1] = False
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    u_fg, u_bg = jax_draws(keys, k + g)
    got = tt.sample_fastrcnn_targets(T(props), T(pvalid), T(gt), T(labels),
                                     T(gvalid), 16, 0.25, 0.5, u_fg=u_fg,
                                     u_bg=u_bg)
    ref = jax.vmap(lambda *a: jt.sample_fastrcnn_targets(*a, 16, 0.25, 0.5))(
        keys, jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt),
        jnp.asarray(labels), jnp.asarray(gvalid))
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    assert got["fg"].any() and (got["valid"] & ~got["fg"]).any()


@pytest.mark.parametrize("kind", ["cosine", "exp", "constant"])
def test_lr_schedules_match_jax(kind):
    kw = dict(init_lr=0.01, warmup_init_lr=0.001, warmup_steps=10,
              total_steps=100, lr_schedule=kind)
    got = make_lr_schedule(TrainConfig(**kw))
    ref = jtrainer.make_lr_schedule(JTrainConfig(**kw))
    for step in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 140):
        assert got(step) == pytest.approx(float(ref(jnp.asarray(step))),
                                          rel=1e-6, abs=1e-9), step


def _opt_params(rng):
    return {"conv": {"W": rng.randn(3, 3, 2, 4).astype(np.float32),
                     "b": rng.randn(4).astype(np.float32)},
            "bn": {"gamma": rng.rand(4).astype(np.float32) + 0.5},
            "fc": {"W": rng.randn(5, 3).astype(np.float32)}}


@pytest.mark.parametrize("optimizer,clip,wd", [
    ("momentum", 0.5, 1e-2), ("momentum", None, 0.0), ("sgd", 10.0, 1e-2),
    ("adam", 0.5, 1e-2), ("adadelta", None, 1e-2)])
def test_optimizers_match_optax(optimizer, clip, wd):
    """Three updates from the same gradients: clip by the global norm
    (0.5 clips, 10 does not), decay on the "W" leaves only, the optimizer,
    the schedule read at counts 0, 1, 2 (a warmup makes each differ)."""
    rng = np.random.RandomState(8)
    kw = dict(optimizer=optimizer, init_lr=0.1, warmup_init_lr=0.01,
              warmup_steps=2, total_steps=10, lr_schedule="cosine",
              momentum=0.9, wd=wd, clip_gradient_norm=clip)
    tree = _opt_params(rng)
    grads = [jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.7).astype(
        np.float32), tree) for _ in range(3)]
    tx = jtrainer.make_optimizer(JTrainConfig(**kw))
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    names = {"conv/W": ("conv", "W"), "conv/b": ("conv", "b"),
             "bn/gamma": ("bn", "gamma"), "fc/W": ("fc", "W")}
    params = {n: torch.nn.Parameter(T(tree[a][b].copy()))
              for n, (a, b) in names.items()}
    opt = Optimizer(params, ["conv/W", "fc/W"], TrainConfig(**kw))
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for n, (a, b) in names.items():
            params[n].grad = T(g[a][b].copy())
        opt.step()
    assert opt.count == 3
    for n, (a, b) in names.items():
        close(params[n].detach(), jp[a][b], rel=1e-5)


def test_trainable_roi_align_backward_matches_jax_vjp():
    """On CPU tensors the trainable ROIAlign's backward is autograd of the
    plain gather: the feature gradients of ``jax.vjp(_xla_multilevel)``
    (f32 and bf16 features, the latter cast back as JAX's ``_mra_bwd``
    does); boxes that require grad get the box half of that VJP (the
    gradient ``_mra_bwd`` also returns), which kernel B1e computes on the
    card."""
    rng = np.random.RandomState(9)
    b, n, c = 2, 11, 8
    feats = [rng.randn(b, 16 >> i, 24 >> i, c).astype(np.float32)
             for i in range(4)]
    boxes = _boxes(rng, (b, n), hi=70.0, max_wh=60.0)
    boxes[0, 0] = [-10, -10, 20, 30]             # over the map's edge
    strides = (4, 8, 16, 32)
    for pool in (7, 14):
        g = rng.randn(b, n, pool, pool, c).astype(np.float32)
        for dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
            jf = tuple(jnp.asarray(f).astype(jdt) for f in feats)
            _, vjp = jax.vjp(lambda f: _xla_multilevel(
                f, jnp.asarray(boxes), strides, pool), jf)
            ref = [np.asarray(x.astype(jnp.float32)) for x in vjp(
                jnp.asarray(g))[0]]
            tf = [T(np.array(f.astype(jnp.float32))).to(dtype)
                  .requires_grad_(True) for f in jf]
            out = RA.multilevel_roi_align_trainable(tf, T(boxes), strides,
                                                    pool)
            out.backward(T(g))
            for f, r in zip(tf, ref):
                assert f.grad.dtype == dtype
                if dtype == torch.float32:
                    close(f.grad, r)
                else:      # both round f32 sums to bf16: one bf16 step
                    np.testing.assert_allclose(
                        f.grad.float().numpy(), r, rtol=2.0 ** -7,
                        atol=1e-5 * max(np.abs(r).max(), 1e-6))
    g = rng.randn(b, n, 7, 7, c).astype(np.float32)
    _, vjp = jax.vjp(lambda bx: _xla_multilevel(
        tuple(jnp.asarray(f) for f in feats), bx, strides, 7),
        jnp.asarray(boxes))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    tb = T(boxes).requires_grad_(True)
    RA.multilevel_roi_align_trainable([T(f) for f in feats], tb, strides,
                                      7).backward(T(g))
    assert np.abs(ref).max() > 0
    close(tb.grad, ref)
