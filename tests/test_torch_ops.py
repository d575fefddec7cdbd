"""The port's box, anchor, NMS and frozen-BN ops against the JAX ops on the
same numpy inputs (CPU, float32). Boxes agree to float32 rounding (1e-4
px: exp and the center/size arithmetic round per op); anchors, NMS picks
and validity must be identical, including score ties, zero-area boxes,
boxes on the image edge and all-invalid inputs."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from object_detection_tracking_tpu.ops import anchors as janchors  # noqa: E402
from object_detection_tracking_tpu.ops import boxes as jboxes  # noqa: E402
from object_detection_tracking_tpu.ops import norm as jnorm  # noqa: E402
from object_detection_tracking_tpu.ops.nms import nms as jnms  # noqa: E402
from object_detection_tracking_tpu_torch.ops import anchors, boxes  # noqa: E402
from object_detection_tracking_tpu_torch.ops.nms import (  # noqa: E402
    nms, sort_desc_stable)
from object_detection_tracking_tpu_torch.ops.norm import (  # noqa: E402
    FrozenBN, bn_relu, frozen_bn)
from torch_port_common import one_torch_thread  # noqa: E402,F401

T = torch.from_numpy


def random_boxes(rng, n, w=96.0, h=64.0):
    x0 = rng.uniform(-10, w, n)
    y0 = rng.uniform(-10, h, n)
    bw = rng.uniform(0, 40, n)
    bh = rng.uniform(0, 40, n)
    b = np.stack([x0, y0, x0 + bw, y0 + bh], -1).astype(np.float32)
    b[::7, 2] = b[::7, 0]                      # zero-width
    b[::11] = 0.0                              # degenerate at the origin
    b[3::13, 2:] = [w, h]                      # on the image edge
    return b


def test_pairwise_iou_matches():
    rng = np.random.RandomState(0)
    a, b = random_boxes(rng, 30), random_boxes(rng, 20)
    ref = np.asarray(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    got = boxes.pairwise_iou(T(a), T(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(boxes.pairwise_iou_np(a, b),
                               jboxes.pairwise_iou_np(a, b), rtol=0, atol=0)


def test_decode_and_clip_match():
    rng = np.random.RandomState(1)
    anchors_ = random_boxes(rng, 50)[:, None, :].repeat(3, 1)
    deltas = rng.randn(50, 3, 4).astype(np.float32) * 2
    deltas[0, 0, 2:] = 50.0                    # hits the decode clip
    clip = float(np.log(96 / 16.0))
    ref = jboxes.clip_boxes(
        jboxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors_), clip),
        (64, 96))
    got = boxes.clip_boxes(boxes.decode_boxes(T(deltas), T(anchors_), clip),
                           (64, 96))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-6)
    assert got.numpy().min() >= 0 and got[..., 2].max() <= 96


def test_host_box_helpers_match():
    rng = np.random.RandomState(2)
    b = random_boxes(rng, 10)
    for name in ("xyxy_to_tlwh", "tlwh_to_xyxy", "tlwh_to_xyah"):
        np.testing.assert_array_equal(getattr(boxes, name)(b),
                                      getattr(jboxes, name)(b))
    for hw in ((720, 1280), (1080, 1920), (480, 640), (1280, 720), (5, 7)):
        assert (boxes.get_new_hw(*hw, 720, 1280)
                == jboxes.get_new_hw(*hw, 720, 1280))


@pytest.mark.parametrize("stride,size,field", [
    (4, 32, (16, 24)), (8, 64, (8, 12)), (64, 512, (1, 2))])
def test_anchors_match(stride, size, field):
    ref = janchors.get_all_anchors(stride, [size], (0.5, 1.0, 2.0), field)
    got = anchors.get_all_anchors(stride, [size], (0.5, 1.0, 2.0), field)
    np.testing.assert_array_equal(got, ref)


def test_sort_desc_stable_breaks_ties_by_lower_index():
    x = np.array([[1, 3, 3, 2, 3, -1e30, -1e30, 2]], np.float32)
    vals, idx = sort_desc_stable(T(x), 6)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))


@pytest.mark.parametrize("case", ["random", "ties", "dense_overlap",
                                  "all_invalid", "some_invalid"])
def test_nms_picks_match_exactly(case):
    rng = np.random.RandomState(3)
    n = 64
    b = random_boxes(rng, n)
    s = rng.rand(n).astype(np.float32)
    v = np.ones(n, bool)
    if case == "ties":
        s = np.round(s * 4) / 4                 # many equal scores
    elif case == "dense_overlap":
        b = np.tile(np.array([[10, 10, 40, 40]], np.float32), (n, 1))
        b += rng.uniform(-3, 3, (n, 4)).astype(np.float32)
        s = np.round(s * 8) / 8
    elif case == "all_invalid":
        v[:] = False
    elif case == "some_invalid":
        v = rng.rand(n) > 0.4
    max_out = 20
    ref_i, ref_v = jnms(jnp.asarray(b), jnp.asarray(s), max_out, 0.5,
                        valid=jnp.asarray(v))
    got_i, got_v = nms(T(b), T(s), max_out, 0.5, valid=T(v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    if case == "all_invalid":
        assert not got_v.any() and (got_i.numpy() == -1).all()


def test_nms_batched_over_leading_dims():
    rng = np.random.RandomState(4)
    b = np.stack([random_boxes(rng, 40) for _ in range(6)]).reshape(2, 3, 40, 4)
    s = np.round(rng.rand(2, 3, 40) * 5).astype(np.float32) / 5
    v = rng.rand(2, 3, 40) > 0.2
    got_i, got_v = nms(T(b), T(s), 16, 0.7, valid=T(v))
    for i in range(2):
        for j in range(3):
            ref_i, ref_v = jnms(jnp.asarray(b[i, j]), jnp.asarray(s[i, j]),
                                16, 0.7, valid=jnp.asarray(v[i, j]))
            np.testing.assert_array_equal(got_i[i, j].numpy(),
                                          np.asarray(ref_i))
            np.testing.assert_array_equal(got_v[i, j].numpy(),
                                          np.asarray(ref_v))


def test_frozen_bn_matches():
    rng = np.random.RandomState(5)
    c = 8
    p = {"gamma": rng.rand(c).astype(np.float32) + 0.5,
         "beta": rng.randn(c).astype(np.float32),
         "mean": rng.randn(c).astype(np.float32),
         "variance": rng.rand(c).astype(np.float32)}
    x = rng.randn(2, 5, 6, c).astype(np.float32)                  # NHWC
    bn = FrozenBN(c)
    for k, v in p.items():
        getattr(bn, k).copy_(T(v))
    xt = T(x).permute(0, 3, 1, 2)                                 # NCHW
    for jf, tf in ((jnorm.frozen_bn, frozen_bn), (jnorm.bn_relu, bn_relu)):
        ref = np.asarray(jf({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x)))
        got = tf(bn, xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)
