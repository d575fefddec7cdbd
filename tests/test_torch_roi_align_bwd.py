"""The tap footprint that kernel B1b (the ROIAlign backward,
csrc/roi_align.cu) uses to decide which output tiles an ROI reaches, held
on the CPU against the gradient itself: ``roi_tap_footprint`` against
autograd of the plain ROIAlign (``multilevel_roi_align_vjp``, the kernel's
spec) and against JAX's VJP of the exact gather (``_xla_multilevel``, the
reference ``_mra_bwd`` differentiates). With a positive upstream gradient
every tap with a nonzero weight leaves a nonzero, so each nonzero must lie
in the footprint of an ROI of its image and level; and, taken one ROI at a
time, the footprint must be tight. The kernel itself is held against the
plain version on the card (tests/test_torch_kernels_cuda.py)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_tracking_tpu.ops.pallas.roi_align_pallas import \
    _xla_multilevel
from object_detection_tracking_tpu_torch.ops import roi_align as RA

T = torch.from_numpy
STRIDES = (4, 8, 16, 32)
B, H, W, C = 2, 64, 96, 3            # image 64x96: levels 16x24 .. 2x3
CASES = ["random", "aspect5_edge", "zero_area", "last_row_col", "outside"]


def case_boxes(case, n=10, seed=0):
    """[B, n, 4] float32 image-coordinate boxes of one kind."""
    rng = np.random.RandomState(seed)
    if case == "random":
        xy = rng.uniform(-8, 90, (B, n, 2))
        wh = np.exp(rng.uniform(np.log(1), np.log(90), (B, n, 2)))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)
    if case == "aspect5_edge":
        side = np.exp(rng.uniform(np.log(6), np.log(60), (B, n)))
        ar = np.where(np.arange(n) % 2 == 0, 5.0, 0.2)
        bw, bh = side * np.sqrt(ar), side / np.sqrt(ar)
        # centres on the image's border, so that every box crosses it
        edge = rng.randint(0, 4, (B, n))
        cx = np.where(edge == 0, 0.0, np.where(edge == 1, W, rng.uniform(
            0, W, (B, n))))
        cy = np.where(edge == 2, 0.0, np.where(edge == 3, H, rng.uniform(
            0, H, (B, n))))
        return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                         cy + bh / 2], -1).astype(np.float32)
    if case == "zero_area":
        x = rng.uniform(-2, W + 2, (B, n))
        y = rng.uniform(-2, H + 2, (B, n))
        d = rng.uniform(1, 40, (B, n))
        kind = np.arange(n) % 3          # a point, a vertical, a horizontal
        return np.stack([x, y, x + np.where(kind == 2, d, 0),
                         y + np.where(kind == 1, d, 0)],
                        -1).astype(np.float32)
    if case == "last_row_col":
        # zero-area boxes at (H_l - 0.5) * stride: every sample lies exactly
        # on row H-1 / column W-1 of p2, where both neighbours are one pixel;
        # and boxes that end on the image's bottom-right corner
        s = STRIDES[0]
        pts = np.array([[(W // s - 0.5) * s, (H // s - 0.5) * s] * 2,
                        [10, (H // s - 0.5) * s, 30, (H // s - 0.5) * s],
                        [(W // s - 0.5) * s, 10, (W // s - 0.5) * s, 30]])
        wh = rng.uniform(2, 50, (B, n - len(pts), 2))
        corner = np.concatenate([np.array([W, H]) - wh,
                                 np.broadcast_to([W, H], wh.shape)], -1)
        return np.concatenate([np.broadcast_to(pts, (B,) + pts.shape),
                               corner], 1).astype(np.float32)
    assert case == "outside"
    wh = rng.uniform(2, 200, (B, n, 2))
    far = np.where((np.arange(n) % 2 == 0)[:, None], [W + 40.0, 0.0],
                   [0.0, -300.0])       # right of the image, or above it
    xy = far + rng.uniform(0, 20, (B, n, 2))
    xy[..., 1] = np.where(np.arange(n) % 2 == 0, xy[..., 1],
                          -xy[..., 1] - wh[..., 1] - 40)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def features():
    rng = np.random.RandomState(1)
    return [T(rng.randn(B, H // s, W // s, C).astype(np.float32))
            for s in STRIDES]


def positive_grad(n, pool, seed=2):
    return T(np.random.RandomState(seed).uniform(
        0.5, 1.5, (B, n, pool, pool, C)).astype(np.float32))


def footprint_cover(feats, boxes, fp, levels):
    """Per level, bool [B, H_l, W_l]: the union of the footprints of the
    ROIs of each image on that level."""
    cover = [torch.zeros(f.shape[:3], dtype=torch.bool) for f in feats]
    for i in range(boxes.shape[0]):
        for j in range(boxes.shape[1]):
            r0, r1, c0, c1 = fp[i, j].tolist()
            cover[int(levels[i, j])][i, r0:r1 + 1, c0:c1 + 1] = True
    return cover


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("case", CASES)
def test_gradient_nonzeros_lie_in_footprints(case, pool):
    feats = features()
    boxes = T(case_boxes(case))
    levels = RA.fpn_map_rois_to_levels(boxes)
    grads = RA.multilevel_roi_align_vjp(feats, boxes, STRIDES, pool,
                                        positive_grad(boxes.shape[1], pool),
                                        levels=levels)
    fp = RA.roi_tap_footprint(feats, boxes, STRIDES, pool, levels=levels)
    assert fp.shape == boxes.shape and fp.dtype == torch.int64
    cover = footprint_cover(feats, boxes, fp, levels)
    for g, cov in zip(grads, cover):
        hit = (g != 0).any(-1)
        assert not (hit & ~cov).any()
    if case == "outside":
        assert (fp == torch.tensor([0, -1, 0, -1])).all()
        assert all((g == 0).all() for g in grads)
    else:
        assert sum(int((g != 0).any(-1).sum()) for g in grads) > 0


@pytest.mark.parametrize("pool", [7, 14])
@pytest.mark.parametrize("case", CASES)
def test_footprint_is_tight_for_each_roi(case, pool):
    """One ROI's gradient alone: its nonzeros start exactly at (r0, c0)
    (the lower neighbours of the first in-map samples weigh 1 - f > 0) and
    end at r1 or r1 - 1 (the upper neighbour of the last sample weighs f,
    which is 0 when that sample lies on a pixel); an empty footprint has
    no nonzero."""
    feats = features()
    boxes = T(case_boxes(case, n=6))
    levels = RA.fpn_map_rois_to_levels(boxes)
    fp = RA.roi_tap_footprint(feats, boxes, STRIDES, pool, levels=levels)
    full = positive_grad(boxes.shape[1], pool)
    clamped = 0
    for i in range(B):
        for j in range(boxes.shape[1]):
            g = torch.zeros_like(full)
            g[i, j] = full[i, j]
            grad = RA.multilevel_roi_align_vjp(feats, boxes, STRIDES, pool,
                                               g, levels=levels)
            lvl = int(levels[i, j])
            assert all((grad[k] == 0).all() for k in range(4) if k != lvl)
            hit = (grad[lvl][i] != 0).any(-1)
            r0, r1, c0, c1 = fp[i, j].tolist()
            if r1 < 0:
                assert (r0, c0, c1) == (0, 0, -1) and not hit.any()
                continue
            rows = hit.any(1).nonzero().flatten()
            cols = hit.any(0).nonzero().flatten()
            assert rows.min() == r0 and cols.min() == c0
            assert r1 - 1 <= rows.max() <= r1
            assert c1 - 1 <= cols.max() <= c1
            h, w = feats[lvl].shape[1:3]
            clamped += (r1 == h - 1) + (c1 == w - 1)
    if case == "last_row_col":
        assert clamped > 0


@pytest.mark.parametrize("case", CASES)
def test_jax_vjp_nonzeros_lie_in_footprints(case):
    """The reference: the feature gradients of jax.vjp(_xla_multilevel),
    as JAX's ``_mra_bwd`` takes them, are zero outside the footprints."""
    pool = 7
    feats = features()
    boxes = case_boxes(case)
    g = positive_grad(boxes.shape[1], pool).numpy()
    _, vjp = jax.vjp(lambda f: _xla_multilevel(
        f, jnp.asarray(boxes), STRIDES, pool),
        tuple(jnp.asarray(f.numpy()) for f in feats))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))[0]]
    tb = T(boxes)
    levels = RA.fpn_map_rois_to_levels(tb)
    fp = RA.roi_tap_footprint(feats, tb, STRIDES, pool, levels=levels)
    cover = footprint_cover(feats, tb, fp, levels)
    for r, cov in zip(ref, cover):
        assert not ((r != 0).any(-1) & ~cov.numpy()).any()


def test_tile_shape_matches_the_kernel_source():
    """BWD_TILE (the wrapper sizes the kernel's scratch by it, and
    chip_smoke.py counts bytes by it) is the kernel's own tile: kTileH rows
    by kTileW columns."""
    src = open(os.path.join(os.path.dirname(RA.__file__), os.pardir, "csrc",
                            "roi_align.cu")).read()
    tile = tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)
                     .group(1)) for name in ("kTileH", "kTileW"))
    assert RA.BWD_TILE == tile
