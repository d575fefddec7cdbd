"""The port's ROIAlign: the plain PyTorch version against the JAX exact
gather (``ops/roi_align.py multilevel_roi_align``) and against the Pallas
kernel run in interpret mode, on the cases of test_pallas_roi_align.py.

Tolerance 1e-4 absolute on unit-normal features: both sides sample the
same fpcoor points in float32, and only the order of the bilinear and 2x2
sums differs. The Pallas kernel is compared at the canonical level
(``levels=``) on boxes of aspect <= 1.8, which fit its DMA window; the port
never demotes a level (the Pallas demotion is a window workaround). The
CUDA kernel's own test is test_torch_kernels_cuda.py (no JAX needed)."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from object_detection_tracking_tpu.ops.roi_align import (  # noqa: E402
    fpn_map_rois_to_levels as jax_levels, multilevel_roi_align as jax_mra)
from object_detection_tracking_tpu_torch.ops import roi_align as RA  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401

STRIDES = (4, 8, 16, 32)


def make_feats(rng, b=1, c=16, h=64, w=96):
    return [rng.randn(b, h // 2 ** i, w // 2 ** i, c).astype(np.float32)
            for i in range(4)]


def make_boxes(rng, b, n, img_w=384, img_h=256, lo=10, hi=200,
               max_aspect=2.0):
    s = np.exp(rng.uniform(np.log(lo), np.log(hi), (b, n)))
    ar = np.exp(rng.uniform(-np.log(max_aspect), np.log(max_aspect), (b, n)))
    w, h = s * np.sqrt(ar), s / np.sqrt(ar)
    x0 = rng.uniform(0, img_w - 10, (b, n))
    y0 = rng.uniform(0, img_h - 10, (b, n))
    return np.stack([x0, y0, np.minimum(x0 + w, img_w),
                     np.minimum(y0 + h, img_h)], -1).astype(np.float32)


def jax_ref(feats, boxes, pool=7, levels=None, valid=None):
    if levels is None:
        out = jax.vmap(lambda f2, f3, f4, f5, bx: jax_mra(
            [f2, f3, f4, f5], bx, STRIDES, pool))(*feats, boxes)
    else:
        out = jax.vmap(lambda f2, f3, f4, f5, bx, lv: jax_mra(
            [f2, f3, f4, f5], bx, STRIDES, pool, levels=lv))(
                *feats, boxes, levels)
    out = np.asarray(out)
    if valid is not None:
        out = np.where(valid[:, :, None, None, None], out, 0.0)
    return out


def port(feats, boxes, pool=7, valid=None, levels=None):
    return RA.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
        STRIDES, pool,
        valid=None if valid is None else torch.from_numpy(valid),
        levels=None if levels is None else torch.from_numpy(levels)).numpy()


def test_levels_match_jax():
    rng = np.random.RandomState(0)
    boxes = make_boxes(rng, 1, 4000, 1280, 720, 1, 900, 5.0)[0]
    boxes[:5] = [[0, 0, 0, 0], [10, 10, 10, 50], [0, 0, 1280, 720],
                 [5, 5, 4, 4], [0, 0, 224, 224]]
    ref = np.asarray(jax_levels(jnp.asarray(boxes)))
    got = RA.fpn_map_rois_to_levels(torch.from_numpy(boxes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("b,n,pool", [(1, 24, 7), (3, 6, 7), (1, 5, 7),
                                      (2, 9, 14)])
def test_matches_jax_for_normal_boxes(b, n, pool):
    """Mixed levels, batched, N not a multiple of any block, P=7 and 14."""
    rng = np.random.RandomState(n)
    feats = make_feats(rng, b=b, h=256, w=384)
    boxes = make_boxes(rng, b, n)
    np.testing.assert_allclose(port(feats, boxes, pool),
                               jax_ref(feats, boxes, pool), atol=1e-4, rtol=0)


def test_large_n():
    rng = np.random.RandomState(6)
    feats = make_feats(rng, c=4, h=256, w=384)
    boxes = make_boxes(rng, 1, 9000)
    np.testing.assert_allclose(port(feats, boxes), jax_ref(feats, boxes),
                               atol=1e-4, rtol=0)


def test_zero_area_and_edge_boxes():
    rng = np.random.RandomState(3)
    feats = make_feats(rng)
    boxes = np.array([[
        [0, 0, 0, 0],               # degenerate
        [0, 0, 96, 64],             # whole image
        [90, 60, 96, 64],           # bottom-right corner
        [50, 20, 50, 40],           # zero width
        [-20, -20, 10, 10],         # partly outside
        [0, 0, 96, 1],              # one-pixel strip on the edge
    ]], np.float32)
    got = port(feats, boxes)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, jax_ref(feats, boxes), atol=1e-4, rtol=0)


def test_aspect5_boxes_keep_canonical_level():
    """The Pallas kernel demotes such boxes to fit its window; the port,
    like the exact XLA path, samples them at their canonical level."""
    rng = np.random.RandomState(5)
    feats = make_feats(rng, h=256, w=384)
    w, h = 108 / np.sqrt(5.0), 108 * np.sqrt(5.0)
    boxes = np.array([[[30.0, 5.0, 30.0 + w, 5.0 + h],
                       [5.0, 100.0, 5.0 + h, 100.0 + w]]], np.float32)
    assert (np.asarray(jax_levels(jnp.asarray(boxes[0]))) == 0).all()
    np.testing.assert_allclose(port(feats, boxes), jax_ref(feats, boxes),
                               atol=1e-4, rtol=0)


def test_valid_skip_gives_exact_zeros():
    rng = np.random.RandomState(7)
    feats = make_feats(rng, b=2, h=256, w=384)
    boxes = make_boxes(rng, 2, 9)
    valid = rng.rand(2, 9) > 0.4
    got = port(feats, boxes, valid=valid)
    full = port(feats, boxes)
    assert np.array_equal(got[valid], full[valid])
    assert np.all(got[~valid] == 0.0)
    np.testing.assert_allclose(got, jax_ref(feats, boxes, valid=valid),
                               atol=1e-4, rtol=0)


def test_explicit_levels_and_bf16_features_match_jax():
    rng = np.random.RandomState(8)
    feats = make_feats(rng, b=2, h=256, w=384)
    boxes = make_boxes(rng, 2, 12)
    levels = rng.randint(0, 4, (2, 12)).astype(np.int32)
    np.testing.assert_allclose(
        port(feats, boxes, levels=levels),
        jax_ref(feats, boxes, levels=levels), atol=1e-4, rtol=0)
    bf = [torch.from_numpy(f).bfloat16() for f in feats]
    got = RA.multilevel_roi_align(bf, torch.from_numpy(boxes), STRIDES, 7)
    ref = jax_ref([f.float().numpy() for f in bf], boxes)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


EFFDET_STRIDES = (8, 16, 32, 64, 128)


def effdet_case(rng, b, n, c=8, size=128):
    """EfficientDet's pooling: P3..P7 of a size x size input (P7 is
    size/128 pixels a side), explicit per-ROI levels, some outside 0..4
    (clamped), JAX's invalid slots (zero box, level 0), and boxes on P7's
    edge."""
    feats = [rng.randn(b, size // s, size // s, c).astype(np.float32)
             for s in EFFDET_STRIDES]
    boxes = make_boxes(rng, b, n, size, size, 2, size, 3.0)
    levels = rng.randint(-2, 8, (b, n)).astype(np.int32)
    boxes[:, 0] = [size - 128, size - 128, size, size]
    levels[:, 0] = 4
    boxes[:, 1] = [0, size - 40, 50, size]
    levels[:, 1] = 9
    boxes[:, -3:] = 0.0
    levels[:, -3:] = 0
    return feats, boxes, levels


@functools.partial(jax.jit, static_argnums=3)
def _jax_mra5(feats, boxes, levels, pool):
    return jax.vmap(lambda f3, f4, f5, f6, f7, bx, lv: jax_mra(
        [f3, f4, f5, f6, f7], bx, EFFDET_STRIDES, pool, levels=lv))(
            *feats, boxes, levels)


def jax_ref5(feats, boxes, levels, pool=7):
    return np.asarray(_jax_mra5(feats, boxes, levels, pool))


@pytest.mark.parametrize("size,c,n", [(128, 8, 12), (256, 32, 30),
                                      (640, 4, 9)])
def test_five_levels_explicit_levels_match_jax(size, c, n):
    """Five levels with explicit, partly out-of-range levels and zero
    boxes: the plain version against JAX ``multilevel_roi_align(...,
    levels=)``, which clamps the levels into 0..4 the same way."""
    rng = np.random.RandomState(size + n)
    feats, boxes, levels = effdet_case(rng, 2, n, c, size)
    got = RA.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
        EFFDET_STRIDES, 7, levels=torch.from_numpy(levels)).numpy()
    ref = jax_ref5(feats, boxes, levels)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    if size >= 256:                             # P7 at least 2 x 2
        assert np.abs(got[:, 0]).max() > 0      # P7's edge box reads
    assert not got[:, -3:].any()                # zero boxes pool to 0
    clamped = RA.multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
        EFFDET_STRIDES, 7,
        levels=torch.from_numpy(levels.clip(0, 4))).numpy()
    assert np.array_equal(got, clamped)


def test_wrapper_five_levels_takes_plain_version_on_cpu():
    rng = np.random.RandomState(21)
    feats, boxes, levels = effdet_case(rng, 2, 10)
    before = RA.multilevel_roi_align_cuda.launches
    got = RA.multilevel_roi_align_cuda(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
        EFFDET_STRIDES, 7, levels=torch.from_numpy(levels)).numpy()
    assert RA.multilevel_roi_align_cuda.launches == before
    np.testing.assert_allclose(got, jax_ref5(feats, boxes, levels),
                               atol=1e-4, rtol=0)


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.RandomState(9)
    feats = make_feats(rng, b=2, h=256, w=384)
    boxes = make_boxes(rng, 2, 7)
    before = RA.multilevel_roi_align_cuda.launches
    got = RA.multilevel_roi_align_cuda(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
        STRIDES, 7).numpy()
    assert RA.multilevel_roi_align_cuda.launches == before
    assert np.array_equal(got, port(feats, boxes))


def test_matches_pallas_kernel_in_interpret_mode(monkeypatch):
    import object_detection_tracking_tpu.ops.pallas.roi_align_pallas as RP
    from jax.experimental import pallas as pl
    monkeypatch.setattr(RP.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.RandomState(10)
    feats = make_feats(rng, b=2, h=256, w=384)
    boxes = make_boxes(rng, 2, 10, max_aspect=1.8)
    valid = rng.rand(2, 10) > 0.3
    levels = np.asarray(jax_levels(jnp.asarray(boxes.reshape(-1, 4)))
                        ).reshape(2, 10)
    ref = np.asarray(RP.multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), STRIDES, 7,
        levels=jnp.asarray(levels), valid=jnp.asarray(valid)))
    got = port(feats, boxes, valid=valid)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert np.all(got[~valid] == 0.0) and np.all(ref[~valid] == 0.0)
