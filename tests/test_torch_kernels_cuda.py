"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here needs a CUDA GPU (marker ``cuda``)
and skips without one; none needs JAX, so on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX for the JAX package's
tests.) ROIAlign: 1e-4 absolute on unit-normal features; kernel and plain
version sample the same float32 fpcoor points, only the order of the sums
differs. Bottleneck stage: float32 (TF32 off) within 1e-4 of the plain
version's largest magnitude, the same float32 sums in another order;
bf16 within 2e-2 of it, the JAX package's own bf16 bound for the Pallas
kernel (test_resnet_stage_pallas.py:66), since one bf16 rounding of an
intermediate that lands the other way moves everything after it.
ROIAlign backward (B1b) against autograd of the plain version: float32
gradients within 1e-5 of the level's largest magnitude (the same products,
added in another order: the kernel's is fixed, so two launches agree bit
for bit); bf16 gradients are those float32 sums rounded once, so two sums
a hair apart may round to neighbouring bf16 values: within one bf16 step
(2^-7 of the value) plus that float32 bound. ROIAlign's box gradient
(B1e) against autograd of the plain version with respect to the boxes:
within 1e-4 of the largest |plain| (float32 sums over 2P samples of
C channels of four taps, in another fixed order; the features' dtype does
not change the products, bf16 converts exactly). Greedy NMS (N1) against
the plain fixpoint: the keep masks bit for bit (the greedy answer is the
fixpoint's unique fixed point, and N1 computes each IOU in the plain
version's float32 operations and order); the forwards make no host sync;
the packed forward's CUDA-graph replay equals its exported graph bit for
bit."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from object_detection_tracking_tpu_torch.config import DetectorConfig
from object_detection_tracking_tpu_torch.models import get_model
from object_detection_tracking_tpu_torch.models import faster_rcnn as FR
from object_detection_tracking_tpu_torch.models.layers import (Conv, conv2d,
                                                               deconv2d)
from object_detection_tracking_tpu_torch.models.resnet import Bottleneck
from object_detection_tracking_tpu_torch.ops import resnet_stage as RS
from object_detection_tracking_tpu_torch.ops import roi_align as RA
from object_detection_tracking_tpu_torch.params import (init_params,
                                                        params_from_jax)

STRIDES = (4, 8, 16, 32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def inputs(dev, dtype, b=2, n=300, c=256, h=256, w=384, seed=11):
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.randn(b, h >> i, w >> i, c)
                              .astype(np.float32)).to(dev, dtype)
             for i in range(4)]
    s = np.exp(rng.uniform(np.log(2), np.log(300), (b, n)))
    ar = np.exp(rng.uniform(-np.log(5), np.log(5), (b, n)))
    x0 = rng.uniform(-5, w, (b, n))
    y0 = rng.uniform(-5, h, (b, n))
    boxes = np.stack([x0, y0, np.minimum(x0 + s * np.sqrt(ar), w),
                      np.minimum(y0 + s / np.sqrt(ar), h)], -1)
    edge = [[0, 0, 0, 0], [0, 0, w, h], [w - 4, h - 4, w, h],
            [50, 20, 50, 40]]
    if n:
        boxes[0, :4] = edge[:n]
    valid = rng.rand(b, n) > 0.3
    return (feats, torch.from_numpy(boxes.astype(np.float32)).to(dev),
            torch.from_numpy(valid).to(dev))


def p2_edge_inputs(dev, dtype, n, b=2, h=1088, w=1920, seed=12):
    """The ActEV pyramid (1088x1920, C=256) with n boxes small enough for
    p2: half of aspect 5, half of aspect 1/5, their centres spread 10%
    past the image on every side, so that many cross the map's edge."""
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.randn(b, h >> (i + 2), w >> (i + 2), 256)
                              .astype(np.float32)).to(dev, dtype)
             for i in range(4)]
    side = np.exp(rng.uniform(np.log(8), np.log(100), (b, n)))
    ar = np.where(np.arange(n) % 2 == 0, 5.0, 0.2)
    bw, bh = side * np.sqrt(ar), side / np.sqrt(ar)
    cx = rng.uniform(-0.1 * w, 1.1 * w, (b, n))
    cy = rng.uniform(-0.1 * h, 1.1 * h, (b, n))
    boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    valid = rng.rand(b, n) > 0.3
    return (feats, torch.from_numpy(boxes.astype(np.float32)).to(dev),
            torch.from_numpy(valid).to(dev))


def off16(t):
    """t's values in a contiguous view that starts one element past a
    16-byte boundary (a storage offset)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool,n,case", [
    (7, 300, "c256"), (7, 5, "c256"), (14, 37, "c256"),
    (7, 40, "c64"),          # ROADMAP B4's width (EfficientDet)
    (7, 40, "c36"),          # C off the vector width: the scalar path
    (32, 6, "c256"),         # the largest pool: two samples per lane
    (7, 1, "c256"),          # one ROI
    (14, 9, "all_invalid"),  # exact zeros; NaN features are never read
    (7, 64, "p2_edge"),      # aspect-5 boxes over p2's edge at 1088x1920
    (7, 50, "off16"),        # levels off 16 bytes: the scalar path
])
def test_roi_align_kernel_matches_plain(cuda, dtype, pool, n, case):
    dt = getattr(torch, dtype)
    if case == "p2_edge":
        feats, boxes, valid = p2_edge_inputs(cuda, dt, n)
        lvl = RA.fpn_map_rois_to_levels(boxes)
        assert (lvl == 0).float().mean().item() >= 0.9
        crosses = (boxes[..., :2] < 0).any(-1) | (boxes[..., 2] > 1920) \
            | (boxes[..., 3] > 1088)
        assert crosses.float().mean().item() >= 0.1
    else:
        c = {"c64": 64, "c36": 36}.get(case, 256)
        feats, boxes, valid = inputs(cuda, dt, n=n, c=c)
    if case == "off16":
        feats = [off16(f) for f in feats]
        assert all(f.data_ptr() % 16 != 0 for f in feats)
    if case == "all_invalid":
        valid = torch.zeros_like(valid)
        feats = [torch.full_like(f, float("nan")) for f in feats]
    before = RA.multilevel_roi_align_cuda.launches
    got = RA.multilevel_roi_align_cuda(feats, boxes, STRIDES, pool,
                                       valid=valid)
    torch.cuda.synchronize()
    assert RA.multilevel_roi_align_cuda.launches == before + 1
    ref = RA.multilevel_roi_align(feats, boxes, STRIDES, pool, valid=valid)
    assert got.shape == ref.shape == (2, n, pool, pool, feats[0].shape[-1])
    assert (got - ref).abs().max().item() <= 1e-4
    assert (got[~valid] == 0).all()
    if case == "all_invalid":
        return
    full = RA.multilevel_roi_align_cuda(feats, boxes, STRIDES, pool)
    ref_full = RA.multilevel_roi_align(feats, boxes, STRIDES, pool)
    assert (full - ref_full).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_roi_align_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    feats, boxes, valid = inputs(cuda, torch.float32, n=8)
    with pytest.raises(ValueError):
        RA.multilevel_roi_align_cuda(feats, boxes.double(), STRIDES, 7)
    with pytest.raises(ValueError):
        RA.multilevel_roi_align_cuda([f.half() for f in feats], boxes,
                                     STRIDES, 7)
    with pytest.raises(ValueError):
        RA.multilevel_roi_align_cuda(
            [f.permute(0, 2, 1, 3) for f in feats], boxes, STRIDES, 7)
    with pytest.raises(ValueError):    # one stride per level
        RA.multilevel_roi_align_cuda(feats[:3], boxes, STRIDES, 7)
    with pytest.raises(ValueError):    # at most five levels
        RA.multilevel_roi_align_cuda(feats + feats[:2], boxes,
                                     STRIDES + (64, 128), 7)
    with pytest.raises(ValueError):    # levels [B, N]
        RA.multilevel_roi_align_cuda(feats, boxes, STRIDES, 7,
                                     levels=torch.zeros(8, device=cuda))


EFFDET_STRIDES = (8, 16, 32, 64, 128)


def effdet_inputs(dev, dtype, c, size=512, b=2, n=100, seed=13):
    """EfficientDet's B1 launch: P3..P7 of a size x size input (P7 is
    size/128 pixels a side), n boxes per image with explicit levels that
    mostly disagree with the canonical map, some out of range (clamped),
    and JAX's invalid slots: zero boxes on level 0. Boxes hug P7's far
    edge and the image's corners."""
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(rng.randn(b, size // s, size // s, c)
                              .astype(np.float32)).to(dev, dtype)
             for s in EFFDET_STRIDES]
    side = np.exp(rng.uniform(np.log(4), np.log(size), (b, n)))
    ar = np.exp(rng.uniform(-np.log(4), np.log(4), (b, n)))
    x0 = rng.uniform(-10, size, (b, n))
    y0 = rng.uniform(-10, size, (b, n))
    boxes = np.stack([x0, y0, x0 + side * np.sqrt(ar),
                      y0 + side / np.sqrt(ar)], -1).clip(0, size)
    levels = rng.randint(-1, 7, (b, n))
    # P7's edge: the last row/column of its 4x4 (at 512) map
    boxes[:, 0] = [size - 128, size - 128, size, size]
    boxes[:, 1] = [size - 40, 0, size, 30]
    levels[:, :2] = 4
    boxes[:, 2] = [0, 0, size, size]
    levels[:, 2] = 0
    invalid = np.zeros((b, n), bool)
    invalid[:, -10:] = True
    boxes[invalid] = 0.0
    levels[invalid] = 0
    return (feats, torch.from_numpy(boxes.astype(np.float32)).to(dev),
            torch.from_numpy(levels.astype(np.int32)).to(dev),
            torch.from_numpy(~invalid).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,size", [(32, 128), (64, 512), (88, 640),
                                    (384, 512), (36, 256)])
def test_roi_align_kernel_five_levels_explicit(cuda, dtype, c, size):
    """EfficientDet's mode: P3..P7, the caller's per-ROI levels (clamped
    into 0..4), at the test width 32, d0's 64, d1's 88, d6/d7's 384 (48
    16-byte chunks: a second pass of a warp's lanes) and 36 (the scalar
    path); invalid zero boxes pooled, not skipped (valid=None), as
    EfficientDet's forward does."""
    dt = getattr(torch, dtype)
    feats, boxes, levels, valid = effdet_inputs(cuda, dt, c, size)
    canon = RA.fpn_map_rois_to_levels(boxes)
    assert (canon != levels.clamp(0, 4)).float().mean().item() > 0.5
    before = RA.multilevel_roi_align_cuda.launches
    got = RA.multilevel_roi_align_cuda(feats, boxes, EFFDET_STRIDES, 7,
                                       levels=levels)
    torch.cuda.synchronize()
    assert RA.multilevel_roi_align_cuda.launches == before + 1
    ref = RA.multilevel_roi_align(feats, boxes, EFFDET_STRIDES, 7,
                                  levels=levels)
    assert got.shape == (2, 100, 7, 7, c)
    assert (got - ref).abs().max().item() <= 1e-4
    assert (got[~valid] == 0).all()
    if size >= 256:                              # P7 at least 2 x 2
        assert got[:, :2].abs().amax().item() > 0   # P7's edge boxes read
    masked = RA.multilevel_roi_align_cuda(feats, boxes, EFFDET_STRIDES, 7,
                                          valid=valid, levels=levels)
    assert torch.equal(masked, got)


@pytest.mark.cuda
def test_roi_align_backward_refuses_five_levels(cuda):
    feats, boxes, levels, _ = effdet_inputs(cuda, torch.float32, 64)
    g = torch.zeros(2, 100, 7, 7, 64, device=cuda)
    with pytest.raises(ValueError, match="exactly 4 levels"):
        RA.multilevel_roi_align_backward_cuda(feats, boxes, EFFDET_STRIDES,
                                              7, g, levels=levels)


@pytest.mark.cuda
def test_efficientdet_forward_with_kernel_matches_plain(cuda):
    """EfficientDet's forward (efficientdet-test, f32, TF32 off) with B1
    against the same forward with the plain ROIAlign: one launch, equal
    detections, embeddings within 1e-4 of their largest magnitude."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = DetectorConfig.coco_partial(
        result_per_im=20, compute_dtype="float32",
        efficientdet_name="efficientdet-test", roi_align_impl="pallas")
    model = get_model(cfg, "efficientdet")
    params_from_jax(init_params(cfg, 0, "efficientdet"), model)
    model = model.to(cuda).eval()
    imgs = torch.from_numpy(np.random.RandomState(5).randint(
        0, 255, (2, 96, 128, 3)).astype(np.uint8)).to(cuda)
    before = RA.multilevel_roi_align_cuda.launches
    got = model(imgs)
    assert RA.multilevel_roi_align_cuda.launches == before + 1
    model.config = dataclasses.replace(cfg, roi_align_impl="xla")
    ref = model(imgs)
    for k in ("final_boxes", "final_labels", "final_valid"):
        assert torch.equal(got[k], ref[k]), k
    scale = ref["pooled_box_feat"].abs().max().item()
    assert (got["pooled_box_feat"] - ref["pooled_box_feat"]).abs().max() \
        .item() <= 1e-4 * scale


@pytest.mark.cuda
def test_forward_with_kernel_matches_plain_roi_align(cuda):
    """A small R18 forward in f32 (TF32 off), ROIAlign through the kernel
    and through the plain version: only ROIAlign differs, by ~1e-6;
    labels and validity must be equal."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DetectorConfig(num_class=5, resnet_depth=18, short_edge_size=64,
                         max_size=96, rpn_test_post_nms_topk=32,
                         result_per_im=8, compute_dtype="float32")
    model = params_from_jax(init_params(cfg, seed=0), get_model(cfg))
    model.to(cuda)
    imgs = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 64, 96, 3)).astype(np.uint8)).to(cuda)
    before = RA.multilevel_roi_align_cuda.launches
    got = model(imgs)
    assert RA.multilevel_roi_align_cuda.launches == before + 2
    model.config = dataclasses.replace(cfg, roi_align_impl="xla")
    ref = model(imgs)
    assert torch.equal(got["final_valid"], ref["final_valid"])
    assert torch.equal(got["final_labels"], ref["final_labels"])
    assert (got["final_boxes"] - ref["final_boxes"]).abs().max() <= 1e-3
    # final boxes move by ~1e-5 px, so the second ROIAlign's features move
    # at first order: 1e-4 of their largest magnitude
    scale = ref["fpn_box_feat"].abs().max()
    assert (got["fpn_box_feat"] - ref["fpn_box_feat"]).abs().max() \
        <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_box_feat_through_the_kernel_matches_plain(cuda, dtype):
    """extract_box_feat on the caller's boxes (some past the image, one of
    zero area, no validity mask): one B1 launch, and the mean-pooled
    features within the kernel's bound (1e-4 of the plain result's largest
    magnitude, as chip_smoke's launch checks) of the plain version on the
    same backbone maps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DetectorConfig(num_class=5, resnet_depth=18, short_edge_size=64,
                         max_size=96, compute_dtype=dtype)
    model = params_from_jax(init_params(cfg, seed=0), get_model(cfg))
    model.to(cuda).eval()
    rng = np.random.RandomState(2)
    imgs = torch.from_numpy(rng.randint(0, 256, (2, 64, 96, 3)).astype(
        np.uint8)).to(cuda)
    xy = rng.uniform(-10, 86, (2, 40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 60, (2, 40, 2))], -1)
    boxes[1, 0] = [20, 20, 20, 20]
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(cuda)
    before = RA.multilevel_roi_align_cuda.launches
    got = model.extract_box_feat(imgs, boxes)
    assert RA.multilevel_roi_align_cuda.launches == before + 1
    model.config = dataclasses.replace(cfg, roi_align_impl="xla")
    ref = model.extract_box_feat(imgs, boxes)
    assert got.shape == ref.shape == (2, 40, 256)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-4 * max(1.0, ref.abs().max())


def stage_blocks(n, c_in, width, seed=0):
    """n stride-1 bottleneck blocks (a shortcut conv on the first when
    c_in != 4 * width), msra weights and non-trivial frozen-BN statistics,
    from numpy."""
    rng = np.random.RandomState(seed)
    blocks, c = [], c_in
    for _ in range(n):
        blk = Bottleneck(c, width, 1, 1, False, False)
        convs = [blk.conv1, blk.conv2, blk.conv3]
        if blk.convshortcut is not None:
            convs.append(blk.convshortcut)
        for conv in convs:
            o, i, kh, kw = conv.weight.shape
            conv.weight.data = torch.from_numpy(
                (rng.randn(o, i, kh, kw) * np.sqrt(2.0 / (i * kh * kw)))
                .astype(np.float32))
            bn = conv.bn
            bn.mean.copy_(torch.from_numpy(rng.randn(o) * 0.1))
            bn.variance.copy_(torch.from_numpy(np.abs(rng.randn(o)) + 0.5))
            bn.gamma.copy_(torch.from_numpy(1 + 0.1 * rng.randn(o)))
            bn.beta.copy_(torch.from_numpy(0.05 * rng.randn(o)))
        blocks.append(blk)
        c = 4 * width
    return blocks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,width,hw", [
    # M = 2 x 23 x 40 = 1840, not a multiple of the 128-pixel tile;
    # shortcut conv; N=32 on the 64-wide tile; conv1's K=64 a single stage
    (1, 64, 32, (23, 40)),
    (2, 64, 32, (23, 40)),
    (3, 64, 64, (17, 30)),      # c2-like: C_in 64, width 64, 256 out
    (2, 128, 32, (23, 40)),     # identity first block
    # width 24: N=24 on the 64-wide tile; the 3x3's K=216 crosses taps
    # inside a 64-deep stage and ends mid-stage
    (3, 96, 24, (9, 13)),
    (2, 512, 128, (7, 11)),     # c3-like: 128-wide tiles, conv3 N=512
    (1, 1024, 256, (9, 14)),    # c4-like: C_in 1024, width 256, K=2304
    (1, 512, 64, (9, 10)),      # 1x1s of K=512 onto N=64 and N=256
    (4, 256, 64, (15, 22)),     # a 4-block stack
])
def test_bottleneck_stage_kernel_matches_plain(cuda, dtype, n, c_in, width,
                                               hw):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    blocks = [b.to(cuda) for b in stage_blocks(n, c_in, width)]
    x = torch.from_numpy(np.random.RandomState(7).randn(
        2, *hw, c_in).astype(np.float32)).to(cuda, dt)
    before = RS.fused_bottleneck_stage_cuda.launches
    got = RS.fused_bottleneck_stage_cuda(blocks, x, width, 4 * width)
    torch.cuda.synchronize()
    assert RS.fused_bottleneck_stage_cuda.launches == before + 1
    ref = RS.fused_bottleneck_stage(blocks, x, width, 4 * width)
    assert got.shape == ref.shape == (2, *hw, 4 * width)
    assert got.dtype == dt
    rel = 1e-4 if dtype == "float32" else 2e-2
    scale = ref.float().abs().max().item()
    d = (got.float() - ref.float()).abs()
    assert d.max().item() <= rel * scale
    # the image edges, where the 3x3 must read zeros
    assert max(d[:, 0].max().item(), d[:, -1].max().item(),
               d[:, :, 0].max().item(), d[:, :, -1].max().item()) \
        <= rel * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind,c_in,c_out,hw", [
    ("conv3x3", 64, 48, (19, 27)), ("conv1x1", 64, 48, (19, 27)),
    ("deconv", 64, 48, (19, 27)),
    # the ActEV path's FPN at its c4 level (68x120): lateral 1x1 from
    # 1024 channels, posthoc 3x3; the mask head's deconv at 14x14
    ("conv1x1", 1024, 256, (68, 120)), ("conv3x3", 256, 256, (68, 120)),
    ("deconv", 256, 256, (14, 14)),
])
def test_bf16_conv_bias_rounds_like_jax(cuda, kind, c_in, c_out, hw):
    """ROADMAP C4: the JAX conv2d and deconv2d round the conv to bf16, then
    add the bf16 bias in bf16 (JAX models/layers.py:81-84, :150-152). The
    port's conv2d and deconv2d must give exactly that on the card."""
    rng = np.random.RandomState(5)
    k = {"conv3x3": 3, "conv1x1": 1, "deconv": 2}[kind]
    p = Conv(k, c_in, c_out)
    p.weight.data = torch.from_numpy(rng.randn(c_out, c_in, k, k).astype(
        np.float32) / np.sqrt(c_in * k * k))
    p.bias.data = torch.from_numpy(rng.randn(c_out).astype(np.float32))
    p.to(cuda)
    x = torch.from_numpy(rng.randn(2, c_in, *hw).astype(np.float32)).to(
        cuda, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = p.weight.to(torch.bfloat16)
    b = p.bias.to(torch.bfloat16)[:, None, None]
    if kind == "deconv":
        got = deconv2d(p, x)
        want = F.conv_transpose2d(x, w.flip(2, 3).transpose(0, 1),
                                  stride=2) + b
    else:
        got = conv2d(p, x)
        want = F.conv2d(x, w, padding=(k - 1) // 2) + b
    d = (got.float() - want.float()).abs()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want), (
        f"{int((d > 0).sum())} of {d.numel()} elements differ, max "
        f"{d.max().item():.4g} (max |want| {want.abs().max().item():.4g})")


@pytest.mark.cuda
def test_bottleneck_stage_wrapper_rejects_what_the_kernel_does_not_take(
        cuda):
    blocks = [b.to(cuda) for b in stage_blocks(2, 64, 16)]
    x = torch.randn(1, 8, 12, 64, device=cuda)
    with pytest.raises(ValueError):
        RS.fused_bottleneck_stage_cuda(blocks, x.half(), 16, 64)
    with pytest.raises(ValueError):
        RS.fused_bottleneck_stage_cuda(blocks, x.permute(0, 2, 1, 3), 16, 64)
    odd = [b.to(cuda) for b in stage_blocks(1, 60, 15)]
    with pytest.raises(ValueError):
        RS.fused_bottleneck_stage_cuda(odd, torch.randn(1, 8, 12, 60,
                                                        device=cuda), 15, 60)
    # rows must start on 16 bytes (TMA, 16-byte copies)
    shifted = torch.randn(1 * 8 * 12 * 64 + 1, device=cuda)[1:]
    with pytest.raises(ValueError):
        RS.fused_bottleneck_stage_cuda(blocks, shifted.view(1, 8, 12, 64),
                                       16, 64)


@pytest.mark.cuda
def test_forward_with_fused_backbone_matches_unfused(cuda):
    """A small R50 forward in f32 (TF32 off) with backbone_impl "pallas"
    (four stage launches: c2..c5 tails, no dilation) against "xla": the
    c2..c5 maps within 1e-4 of their largest magnitude, labels and
    validity equal."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DetectorConfig(num_class=5, resnet_depth=50, short_edge_size=64,
                         max_size=96, rpn_test_post_nms_topk=32,
                         result_per_im=8, compute_dtype="float32",
                         backbone_impl="pallas")
    tree = init_params(cfg, seed=0)
    for gname, group in tree["resnet"].items():
        if gname.startswith("group"):
            for blk in group.values():
                blk["conv3"]["bn"]["gamma"] *= 0.2
    fused = params_from_jax(tree, get_model(cfg)).to(cuda)
    plain = params_from_jax(tree, get_model(dataclasses.replace(
        cfg, backbone_impl="xla"))).to(cuda)
    x = torch.randn(2, 3, 64, 96, device=cuda).contiguous(
        memory_format=torch.channels_last)
    before = RS.fused_bottleneck_stage_cuda.launches
    with torch.inference_mode():
        got = fused.resnet(x)
        ref = plain.resnet(x)
    assert RS.fused_bottleneck_stage_cuda.launches == before + 4
    for g, r in zip(got, ref):
        assert (g - r).abs().max() <= 1e-4 * r.abs().max()
    imgs = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 64, 96, 3)).astype(np.uint8)).to(cuda)
    a, b = fused(imgs), plain(imgs)
    assert torch.equal(a["final_valid"], b["final_valid"])
    assert torch.equal(a["final_labels"], b["final_labels"])


# --------------------------------------------------------------------------
# B1b: the ROIAlign backward kernel


def bwd_check(feats, boxes, pool, seed=3):
    """B1b against autograd of the plain version on one upstream gradient;
    returns the kernel's gradients."""
    b, n = boxes.shape[:2]
    c = feats[0].shape[-1]
    g = torch.from_numpy(np.random.RandomState(seed).randn(
        b, n, pool, pool, c).astype(np.float32)).to(boxes.device)
    lvl = RA.fpn_map_rois_to_levels(boxes)
    # leave NaN where the gradients will be allocated: every element the
    # kernel does not write shows
    junk = torch.full((sum(f.numel() for f in feats),), float("nan"),
                      dtype=feats[0].dtype, device=boxes.device)
    del junk
    before = RA.multilevel_roi_align_backward_cuda.launches
    got = RA.multilevel_roi_align_backward_cuda(feats, boxes, STRIDES, pool,
                                                g, levels=lvl)
    torch.cuda.synchronize()
    assert RA.multilevel_roi_align_backward_cuda.launches == before + 1
    ref = RA.multilevel_roi_align_vjp(feats, boxes, STRIDES, pool, g,
                                      levels=lvl)
    for f, gk, gr in zip(feats, got, ref):
        assert gk.shape == gr.shape == f.shape and gk.dtype == f.dtype
        gk, gr = gk.float(), gr.float()
        tol = 1e-5 * gr.abs().max().item()
        if f.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * gr.abs()
        assert ((gk - gr).abs() <= tol).all()
    return got


def pyramid(dev, dtype, h, w, c=256, b=2, seed=13):
    """Unit-normal features of a p2 map of h x w pixels and the three
    levels above it (image 4h x 4w)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, h >> i, w >> i, c)
                             .astype(np.float32)).to(dev, dtype)
            for i in range(4)]


def tile_edge_boxes(case, dev):
    """[2, n, 4] boxes for the cases that B1b's output tiles (RA.BWD_TILE
    pixels) can get wrong."""
    th, tw = RA.BWD_TILE
    if case == "p5_whole":
        # p5 boxes over the whole 1088x1920 image: each footprint spans
        # every tile of p5 (34 x 60, its last tiles partial)
        boxes = [[0, 0, 1920, 1088], [-50, -40, 1990, 1130],
                 [1, 3, 1917, 1085], [0, 0, 1920, 600]]
    elif case == "tile_border":
        # p2 point and 4-pixel boxes whose footprints start or end on a
        # tile border, or straddle one: a zero-area box at image coordinate
        # v = 4k samples p2 at k - 0.5, so its rows are (k - 1, k)
        pts = [4 * (th - 1), 4 * th, 4 * (th + 1), 4 * (tw - 1), 4 * tw,
               4 * (tw + 1)]
        boxes = [[x, y, x + dx, y + dy] for x in pts for y in pts
                 for dx in (0, 16) for dy in (0, 16)]
    else:
        assert case == "last_row_col"
        # p2 of 70 x 100 (its last tiles partial): boxes whose samples lie
        # exactly on row 69 / column 99, where both neighbours are one
        # pixel, and boxes that end on the image's corner at every level
        h, w = 4 * 70, 4 * 100
        boxes = [[w - 2, h - 2, w - 2, h - 2], [20, h - 2, 200, h - 2],
                 [w - 2, 10, w - 2, 150]]
        boxes += [[w - s, h - s, w, h] for s in (3, 9, 40, 100, 250)]
        boxes += [[w - s, 0, w, h] for s in (8, 30)]
    t = torch.tensor(boxes, dtype=torch.float32, device=dev)
    return torch.stack([t, t.flip(0)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool,n,case", [
    (7, 300, "c256"), (14, 37, "c256"),
    (7, 40, "c64"),
    (7, 40, "c36"),          # C off the 8-channel store: 8-byte bf16 stores
    (7, 40, "c30"),          # C off the vector width: the scalar path
    (7, 1, "c256"),          # one ROI
    (7, 64, "p2_edge"),      # aspect-5 boxes over p2's edge at 1088x1920
    (14, 64, "p2_edge"),
    (7, 500, "one_pixel"),   # every ROI on the same few pixels
    (7, 4, "p5_whole"),      # a footprint over every tile of p5
    (14, 4, "p5_whole"),
    (7, 144, "tile_border"),  # footprints that end on a tile's border
    (7, 10, "last_row_col"),  # taps on row H-1 and column W-1
    (14, 10, "last_row_col"),
    (7, 30, "p2_only"),      # p3..p5 reached by no ROI: all zeros
    (7, 0, "n0"),            # no ROI at all: every level zeros
    (7, 64, "unplanned"),    # B=4: too many tiles to order, all scan
])
def test_roi_align_backward_kernel_matches_plain(cuda, dtype, pool, n, case):
    dt = getattr(torch, dtype)
    if case == "unplanned":
        feats, boxes, _ = p2_edge_inputs(cuda, dt, n, b=4)
        th, tw = RA.BWD_TILE
        assert 4 * sum(-(-f.shape[1] // th) * -(-f.shape[2] // tw)
                       for f in feats) > 8192   # kPlanMaxPairs
    elif case == "p2_edge":
        feats, boxes, _ = p2_edge_inputs(cuda, dt, n)
        crosses = (boxes[..., :2] < 0).any(-1) | (boxes[..., 2] > 1920) \
            | (boxes[..., 3] > 1088)
        assert crosses.float().mean().item() >= 0.1
    elif case in ("p5_whole", "tile_border", "last_row_col"):
        boxes = tile_edge_boxes(case, cuda)
        assert boxes.shape[1] == n
        feats = pyramid(cuda, dt, *((70, 100) if case == "last_row_col"
                                    else (272, 480)))
    else:
        c = {"c64": 64, "c36": 36, "c30": 30}.get(case, 256)
        feats, boxes, _ = inputs(cuda, dt, n=n, c=c)
    lvl = RA.fpn_map_rois_to_levels(boxes)
    fp = RA.roi_tap_footprint(feats, boxes, STRIDES, pool, levels=lvl)
    if case == "one_pixel":
        # 8x8-pixel boxes at one spot (2x2 pixels of p2): 500 ROIs x 49
        # bins x 16 taps add into the same 4x4 pixels per channel
        boxes[:] = torch.tensor([40.0, 40.0, 48.0, 48.0], device=cuda)
    elif case == "p2_only":
        boxes[..., 2:] = boxes[..., :2] + 6.0
        assert (RA.fpn_map_rois_to_levels(boxes) == 0).all()
    elif case == "p5_whole":
        # the first and third box reach every tile row and column of p5
        th, tw = RA.BWD_TILE
        whole = fp[0, [0, 2]]
        assert (lvl == 3).all() and (whole[:, 0] < th).all() \
            and (whole[:, 1] >= 34 // th * th).all() \
            and (whole[:, 2] < tw).all() \
            and (whole[:, 3] >= 60 // tw * tw).all()
    elif case == "tile_border":
        th, tw = RA.BWD_TILE
        assert (fp[..., 1] % th == th - 1).any() \
            and (fp[..., 0] % th == 0).any() \
            and (fp[..., 3] % tw == tw - 1).any() \
            and (fp[..., 2] % tw == 0).any()
    elif case == "last_row_col":
        assert (fp[..., 1] == 69).any() and (fp[..., 3] == 99).any()
    got = bwd_check(feats, boxes, pool)
    if case == "one_pixel":
        assert got[0].float().abs().amax(-1).gt(0).sum().item() <= 2 * 16
    if case == "p2_only":
        assert all((g == 0).all() for g in got[1:])
    if case == "n0":
        assert all((g == 0).all() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["p2_edge", "one_pixel"])
def test_roi_align_backward_kernel_is_deterministic(cuda, dtype, case):
    """Each gradient element has one writer, which adds its taps in a fixed
    order: two launches on the same inputs agree bit for bit, also where
    500 ROIs add into the same pixels."""
    dt = getattr(torch, dtype)
    feats, boxes, _ = p2_edge_inputs(cuda, dt, 500)
    if case == "one_pixel":
        boxes[:] = torch.tensor([40.0, 40.0, 48.0, 48.0], device=cuda)
    g = torch.from_numpy(np.random.RandomState(4).randn(
        *boxes.shape[:2], 7, 7, 256).astype(np.float32)).to(cuda)
    a = RA.multilevel_roi_align_backward_cuda(feats, boxes, STRIDES, 7, g)
    b = RA.multilevel_roi_align_backward_cuda(feats, boxes, STRIDES, 7, g)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int16 if dt == torch.bfloat16
                                  else torch.int32),
                           y.view(torch.int16 if dt == torch.bfloat16
                                  else torch.int32))


# --------------------------------------------------------------------------
# B1e: the ROIAlign box-gradient kernel


def box_grad_check(feats, boxes, pool, seed=5):
    """B1e against autograd of the plain version on one upstream gradient;
    returns the kernel's gradient."""
    b, n = boxes.shape[:2]
    c = feats[0].shape[-1]
    g = torch.from_numpy(np.random.RandomState(seed).randn(
        b, n, pool, pool, c).astype(np.float32)).to(boxes.device)
    lvl = RA.fpn_map_rois_to_levels(boxes)
    before = RA.multilevel_roi_align_box_grad_cuda.launches
    got = RA.multilevel_roi_align_box_grad_cuda(feats, boxes, STRIDES, pool,
                                                g, levels=lvl)
    torch.cuda.synchronize()
    # no ROI, no launch
    assert RA.multilevel_roi_align_box_grad_cuda.launches == before + (
        1 if b * n else 0)
    ref = RA.multilevel_roi_align_box_vjp(feats, boxes, STRIDES, pool, g,
                                          levels=lvl)
    assert got.shape == ref.shape == (b, n, 4) and got.dtype == torch.float32
    if b * n == 0:
        return got
    assert torch.isfinite(got).all()
    assert ((got - ref).abs() <= 1e-4 * ref.abs().max().item()).all()
    again = RA.multilevel_roi_align_box_grad_cuda(feats, boxes, STRIDES,
                                                  pool, g, levels=lvl)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool,n,case", [
    (7, 300, "c256"), (14, 37, "c256"),
    (7, 40, "c36"),          # float32 vector path, bf16 scalar path
    (7, 40, "c30"),          # C off the vector width: the scalar path
    (7, 40, "off16"),        # levels off 16 bytes: the scalar path
    (7, 64, "p2_edge"),      # aspect-5 boxes over p2's edge at 1088x1920
    (7, 10, "last_row_col"),  # samples on row H-1 and column W-1
    (14, 4, "p5_whole"),
    (7, 0, "n0"),
    (7, 1000, "dense_p2"),    # sub-pixel spacing: bins share most taps;
                              # 2000 ROIs, more than a wave of blocks
    (7, 9, "out_of_map"),    # zero, zero-width, outside, last row/column
    (32, 6, "c256"),         # the largest pool: two samples per lane
    (7, 300, "repeated"),    # boxes repeated, as the SO classes repeat them
    (7, 40, "c40"),          # a vector path with lanes left idle
])
def test_roi_align_box_grad_kernel_matches_plain(cuda, dtype, pool, n, case):
    dt = getattr(torch, dtype)
    if case == "dense_p2":
        feats = pyramid(cuda, dt, 272, 480)
        boxes = dense_p2_boxes(n, cuda)
        assert (RA.fpn_map_rois_to_levels(boxes) == 0).all()
        # sample spacing on p2 (stride 4) under a pixel on both axes
        assert ((boxes[..., 2:] - boxes[..., :2]) / (4 * 2 * pool)).max() < 1
    elif case == "out_of_map":
        feats = pyramid(cuda, dt, 272, 480)
        boxes = torch.tensor(OUT_OF_MAP_BOXES, dtype=torch.float32,
                             device=cuda)[None].repeat(
            2, 1, 1)
    elif case == "p2_edge":
        feats, boxes, _ = p2_edge_inputs(cuda, dt, n)
    elif case in ("p5_whole", "last_row_col"):
        boxes = tile_edge_boxes(case, cuda)
        assert boxes.shape[1] == n
        feats = pyramid(cuda, dt, *((70, 100) if case == "last_row_col"
                                    else (272, 480)))
    elif case == "repeated":
        feats, boxes = pyramid(cuda, dt, 272, 480), repeated_boxes(n, cuda)
    else:
        c = {"c36": 36, "c30": 30, "c40": 40}.get(case, 256)
        feats, boxes, _ = inputs(cuda, dt, n=n, c=c)
        if case == "off16":
            feats = [off16(f) for f in feats]
    got = box_grad_check(feats, boxes, pool)
    if n:
        assert got.abs().max() > 0
    if case == "out_of_map":
        # no sample in the map: exact zeros; samples on p2's last row
        # (column): exact zeros along y (x)
        assert (got[:, [0, 2, 3, 6]] == 0).all()
        assert (got[:, 7, 1::2] == 0).all() and (got[:, 8, ::2] == 0).all()
        assert (got[:, 7, ::2] != 0).all() and (got[:, 8, 1::2] != 0).all()


# image boxes on the 1088x1920 pyramid (p2 272 x 480): a zero box, zero
# width, wholly outside the image on either side, a zero-area box whose
# samples all lie on p2's last row and column (iy = 271, ix = 479), the
# whole image, a corner box, zero height on the last row, zero width on
# the last column
OUT_OF_MAP_BOXES = [
    [0, 0, 0, 0], [50, 20, 50, 90], [2000, 1200, 2100, 1300],
    [-300, -200, -10, -20], [0, 0, 1920, 1088], [1700, 900, 1920, 1088],
    [1918, 1086, 1918, 1086], [20, 1086, 200, 1086], [1918, 10, 1918, 150]]


def repeated_boxes(n, dev, b=2, seed=15):
    """[b, n, 4] boxes on the 1088x1920 image, each image's drawn from
    n // 3 boxes, each three times in a random order, and the first nine
    one box, as the small-object heads' classes repeat the class-agnostic
    boxes."""
    rng = np.random.RandomState(seed)
    side = np.exp(rng.uniform(np.log(16), np.log(600), (b, n // 3)))
    ar = np.exp(rng.uniform(-np.log(3), np.log(3), (b, n // 3)))
    bw, bh = side * np.sqrt(ar), side / np.sqrt(ar)
    x0 = rng.uniform(-100, 1900, (b, n // 3))
    y0 = rng.uniform(-100, 1000, (b, n // 3))
    base = np.stack([x0, y0, x0 + bw, y0 + bh], -1)
    pick = np.stack([rng.permutation(np.arange(n) % (n // 3))
                     for _ in range(b)])
    pick[:, :9] = 0
    boxes = np.take_along_axis(base, pick[..., None], 1)
    return torch.from_numpy(boxes.astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_box_grad_kernel_rois_are_independent(cuda, dtype):
    """Each ROI's gradient is computed by its own block in a fixed order,
    whatever the other ROIs are: permuting the ROIs of each image (with
    repeated boxes among them) permutes the result bit for bit."""
    dt = getattr(torch, dtype)
    feats, boxes = pyramid(cuda, dt, 272, 480), repeated_boxes(300, cuda)
    g = torch.from_numpy(np.random.RandomState(6).randn(
        2, 300, 7, 7, 256).astype(np.float32)).to(cuda)
    perm = torch.from_numpy(np.random.RandomState(7).permutation(300)).to(
        cuda)
    got = RA.multilevel_roi_align_box_grad_cuda(feats, boxes, STRIDES, 7, g)
    moved = RA.multilevel_roi_align_box_grad_cuda(
        feats, boxes[:, perm].contiguous(), STRIDES, 7,
        g[:, perm].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(moved.view(torch.int32),
                       got[:, perm].view(torch.int32))


def dense_p2_boxes(n, dev, b=2, seed=14):
    """[b, n, 4] boxes of 8-40 px a side (aspect 1/1.4..1.4) inside a
    1088x1920 image: all on p2, at a sample spacing under a pixel at P=7."""
    rng = np.random.RandomState(seed)
    side = np.exp(rng.uniform(np.log(8), np.log(40), (b, n)))
    ar = np.exp(rng.uniform(-np.log(1.4), np.log(1.4), (b, n)))
    bw, bh = side * np.sqrt(ar), side / np.sqrt(ar)
    x0 = rng.uniform(0, 1, (b, n)) * (1920 - bw)
    y0 = rng.uniform(0, 1, (b, n)) * (1088 - bh)
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], -1)
    return torch.from_numpy(boxes.astype(np.float32)).to(dev)


@pytest.mark.cuda
def test_trainable_roi_align_runs_both_kernels(cuda):
    """multilevel_roi_align_trainable on CUDA tensors: B1 forward, B1b
    backward, feature gradients as autograd of the plain version; boxes
    that require grad also get theirs, from B1e, as autograd of the plain
    version; detached boxes launch no B1e."""
    feats, boxes, _ = inputs(cuda, torch.float32, n=50)
    feats = [f.requires_grad_(True) for f in feats]
    f0, b0, e0 = RA.multilevel_roi_align_cuda.launches, \
        RA.multilevel_roi_align_backward_cuda.launches, \
        RA.multilevel_roi_align_box_grad_cuda.launches
    out = RA.multilevel_roi_align_trainable(feats, boxes, STRIDES, 7)
    g = torch.randn_like(out)
    out.backward(g)
    assert RA.multilevel_roi_align_cuda.launches == f0 + 1
    assert RA.multilevel_roi_align_backward_cuda.launches == b0 + 1
    assert RA.multilevel_roi_align_box_grad_cuda.launches == e0
    ref = RA.multilevel_roi_align_vjp(feats, boxes, STRIDES, 7, g)
    for f, r in zip(feats, ref):
        assert (f.grad - r).abs().max() <= 1e-5 * r.abs().max()
    bx = boxes.clone().requires_grad_(True)
    RA.multilevel_roi_align_trainable(feats, bx, STRIDES, 7).backward(g)
    assert RA.multilevel_roi_align_box_grad_cuda.launches == e0 + 1
    ref = RA.multilevel_roi_align_box_vjp(feats, boxes, STRIDES, 7, g)
    assert (bx.grad - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.cuda
def test_train_step_runs_no_plain_roi_align(cuda, monkeypatch):
    """A small R18 forward_train + backward on the card with the train
    CLI's roi_align_train_impl="pallas" and add_mask: B1 and B1b each
    launch twice (box head, mask head) and the plain ROIAlign and its
    autograd never run."""
    cfg = DetectorConfig(num_class=4, resnet_depth=18, short_edge_size=48,
                         max_size=64, rpn_train_post_nms_topk=32,
                         rpn_batch_per_im=32, fastrcnn_batch_per_im=16,
                         compute_dtype="bfloat16", is_train=True, freeze=-1,
                         add_mask=True, roi_align_train_impl="pallas")
    model = params_from_jax(init_params(cfg, seed=0), get_model(cfg))
    model.to(cuda)

    def plain(*a, **k):
        raise AssertionError("the plain ROIAlign ran on the card")
    monkeypatch.setattr(RA, "multilevel_roi_align", plain)
    monkeypatch.setattr(RA, "multilevel_roi_align_vjp", plain)
    monkeypatch.setattr(FR, "multilevel_roi_align", plain)
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randint(0, 255, (2, 48, 64, 3)).astype(
        np.uint8)).to(cuda)
    xy = rng.uniform(0, 30, (2, 4, 2))
    wh = rng.uniform(6, 16, (2, 4, 2))
    gt = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32)).to(cuda)
    labels = torch.from_numpy(rng.randint(1, 4, (2, 4))).to(cuda)
    valid = torch.ones(2, 4, dtype=torch.bool, device=cuda)
    masks = torch.ones(2, 4, 28, 28, device=cuda)
    f0, b0 = RA.multilevel_roi_align_cuda.launches, \
        RA.multilevel_roi_align_backward_cuda.launches
    gen = torch.Generator(device=cuda).manual_seed(0)
    losses = model.forward_train(imgs, gt, labels, valid, gt_masks=masks,
                                 generator=gen)
    losses["total_loss"].backward()
    torch.cuda.synchronize()
    assert RA.multilevel_roi_align_cuda.launches == f0 + 2
    assert RA.multilevel_roi_align_backward_cuda.launches == b0 + 2
    assert all(torch.isfinite(v) for v in losses.values())
    # bf16 activations, float32 parameters: float32 gradients, as jax.grad
    for p in (model.fpn.posthoc_3x3_p2.weight, model.maskrcnn.fcn0.weight,
              model.resnet.group0.block0.conv1.bn.gamma):
        assert p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()


def so_config(**kw):
    """A small R18 configuration with the small-object heads and the
    person association (ActEV's 16 classes: Prop, Push_Pulled_Object and
    Bike are its small objects)."""
    return DetectorConfig(**{**dict(
        num_class=16, resnet_depth=18, short_edge_size=64, max_size=128,
        rpn_test_post_nms_topk=64, rpn_train_post_nms_topk=64,
        rpn_batch_per_im=32, fastrcnn_batch_per_im=32, result_per_im=4,
        so_person_topk=2, fpn_frcnn_fc_head_dim=256,
        use_small_object_head=True, use_so_association=True), **kw})


@pytest.mark.cuda
def test_small_object_train_step_runs_b1e(cuda, monkeypatch):
    """forward_train + backward with the small-object heads on the card:
    B1 and B1b launch twice (box head, the SO pooling), B1e once (the SO
    pooling's boxes), the plain ROIAlign never; the box head's gradient
    is finite."""
    cfg = so_config(compute_dtype="bfloat16", is_train=True, freeze=-1,
                    roi_align_train_impl="pallas")
    model = params_from_jax(init_params(cfg, seed=0), get_model(cfg))
    model.to(cuda)

    def plain(*a, **k):
        raise AssertionError("the plain ROIAlign ran on the card")
    for name in ("multilevel_roi_align", "multilevel_roi_align_vjp",
                 "multilevel_roi_align_box_vjp"):
        monkeypatch.setattr(RA, name, plain)
    monkeypatch.setattr(FR, "multilevel_roi_align", plain)
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randint(0, 255, (2, 64, 128, 3)).astype(
        np.uint8)).to(cuda)
    xy = rng.uniform(0, 60, (2, 4, 2))
    wh = rng.uniform(8, 40, (2, 4, 2))
    gt = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32)).to(cuda)
    labels = torch.tensor([[2, 12, 10, 13]] * 2, device=cuda)
    valid = torch.ones(2, 4, dtype=torch.bool, device=cuda)
    counts = [RA.multilevel_roi_align_cuda.launches,
              RA.multilevel_roi_align_backward_cuda.launches,
              RA.multilevel_roi_align_box_grad_cuda.launches]
    gen = torch.Generator(device=cuda).manual_seed(0)
    losses = model.forward_train(imgs, gt, labels, valid, generator=gen)
    losses["total_loss"].backward()
    torch.cuda.synchronize()
    assert [RA.multilevel_roi_align_cuda.launches,
            RA.multilevel_roi_align_backward_cuda.launches,
            RA.multilevel_roi_align_box_grad_cuda.launches] == [
        counts[0] + 2, counts[1] + 2, counts[2] + 1]
    assert all(torch.isfinite(v) for v in losses.values())
    assert torch.isfinite(model.fastrcnn.outputs["box"].weight.grad).all()


@pytest.mark.cuda
def test_small_object_forward_with_kernel_matches_plain(cuda):
    """The f32 forward (TF32 off) with the small-object heads: the
    kernel's SO outputs equal the plain ROIAlign's (valid slots and labels
    equal, boxes within 1e-3 px, probabilities within 1e-5); B1 launches 3
    times (proposals, final boxes, the SO pooling)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = so_config(compute_dtype="float32")
    model = params_from_jax(init_params(cfg, seed=0), get_model(cfg))
    model.to(cuda)
    imgs = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (2, 64, 128, 3)).astype(np.uint8)).to(cuda)
    before = RA.multilevel_roi_align_cuda.launches
    got = model(imgs)
    assert RA.multilevel_roi_align_cuda.launches == before + 3
    model.config = dataclasses.replace(cfg, roi_align_impl="xla")
    ref = model(imgs)
    assert torch.equal(got["so_final_valid"], ref["so_final_valid"])
    assert torch.equal(got["so_final_labels"], ref["so_final_labels"])
    assert (got["so_final_boxes"] - ref["so_final_boxes"]).abs().max() <= 1e-3
    assert (got["so_final_probs"] - ref["so_final_probs"]).abs().max() <= 1e-5


# --------------------------------------------------------------------------
# greedy NMS (kernel N1) and the packed forward


def nms_sorted(boxes, valid, scores=None):
    """Score-sorted (boxes, valid) as ``ops.nms.nms`` hands them to the
    keep op (the given order where ``scores`` is None)."""
    if scores is None:
        return boxes, valid
    order = np.argsort(-np.where(valid, scores, -1e30), -1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], -2),
            np.take_along_axis(valid, order, -1))


def n1_check(cuda, boxes, valid, thres):
    """N1 against the plain fixpoint, bit for bit (the CPU's and the
    card's plain version agree too); one launch counted."""
    from object_detection_tracking_tpu_torch.ops import nms as N
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    ref = N.greedy_keep_plain(b, v, thres)
    before = N.greedy_keep_cuda.launches
    got = N.greedy_keep_cuda(b.to(cuda), v.to(cuda), thres)
    torch.cuda.synchronize()
    assert N.greedy_keep_cuda.launches == before + 1
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(N.greedy_keep_plain(b.to(cuda), v.to(cuda),
                                           thres).cpu(), ref)
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ties", "all_overlapping", "all_invalid",
                                  "n1", "n37", "n64", "n65", "n129", "n130",
                                  "n200", "disjoint", "degenerate",
                                  "negative_threshold", "threshold_0.7",
                                  "threshold_0.5", "threshold_0.3"])
def test_nms_kernel_matches_plain_cases(cuda, name):
    """N1 on tests/torch_nms_cases.py's cases (the CPU test holds the
    plain version against JAX on the same ones)."""
    from torch_nms_cases import make_case
    b, s, v, thres, _ = make_case(name)
    keep = n1_check(cuda, *nms_sorted(b, v, s), thres)
    if name.startswith("threshold"):
        assert keep.tolist() == [[True, True], [True, True], [True, False]]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["proposals_test", "proposals_train",
                                  "predictions", "effdet", "small_objects"])
@pytest.mark.parametrize("thres", [0.7, 0.5])
def test_nms_kernel_matches_plain_at_path_shapes(cuda, path, thres):
    from torch_nms_cases import PATH_SHAPES, path_case
    boxes, valid = path_case(PATH_SHAPES[path], seed=len(path))
    keep = n1_check(cuda, boxes, valid, thres)
    assert 0 < keep.sum() < valid.sum()     # something suppressed


@pytest.mark.cuda
def test_nms_kernel_nan_coordinates(cuda):
    """A NaN coordinate makes every IOU of its box NaN, which the plain
    version's `union > 0` turns into 0: never suppressed, never
    suppressing (the kernel's zero-intersection branch)."""
    from torch_nms_cases import path_case
    boxes, valid = path_case((4, 300), seed=5)
    rng = np.random.RandomState(5)
    nan = rng.rand(4, 300, 4) < 0.05
    boxes[nan] = np.nan
    keep = n1_check(cuda, boxes, valid, 0.5)
    assert keep[torch.from_numpy(nan.any(-1) & valid)].all()


def nms_regime(cuda, shape):
    """N1's launch for ``shape``; its regime against the card's SMs: a
    cluster of 2-8 CTAs a group up to half the SMs' count of groups, one
    CTA a group above (csrc/nms.cu nms_plan)."""
    from object_detection_tracking_tpu_torch.ops import nms as N
    groups = int(np.prod(shape[:-1]))
    plan = N.greedy_keep_plan(groups, shape[-1], cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if 2 * groups > sms:
        assert plan["cluster"] == 1 and plan["ctas"] == groups
    else:
        assert 2 <= plan["cluster"] <= 8
        assert plan["ctas"] == groups * plan["cluster"] <= sms
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 5, 2000), (8, 90, 200)],
                         ids=["cluster", "cta_a_group"])
def test_nms_kernel_regimes(cuda, shape):
    """Both launch regimes, bit for bit: a cluster of CTAs a group where
    the groups are few (the training step's proposals), one CTA a group
    where they are many (EfficientDet's classes)."""
    from torch_nms_cases import path_case
    plan = nms_regime(cuda, shape)
    assert (plan["cluster"] > 1) == (shape == (2, 5, 2000))
    boxes, valid = path_case(shape, seed=9)
    for thres in (0.7, 0.5):
        keep = n1_check(cuda, boxes, valid, thres)
        assert 0 < keep.sum() < valid.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("more", [0, 1])
def test_nms_kernel_regime_edge(cuda, more):
    """Groups at half the SM count (a cluster each) and one more (a CTA
    each)."""
    from torch_nms_cases import path_case
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    shape = (sms // 2 + more, 300)
    assert (nms_regime(cuda, shape)["cluster"] > 1) == (more == 0)
    n1_check(cuda, *path_case(shape, seed=3), 0.5)


@pytest.mark.cuda
def test_nms_kernel_largest_group(cuda):
    """N = 8192, the most one CTA's shared memory holds: bit for bit the
    plain version on the card (the CPU's would take minutes)."""
    from object_detection_tracking_tpu_torch.ops import nms as N
    from torch_nms_cases import path_case
    boxes, valid = path_case((1, N.MAX_BOXES), seed=4)
    b, v = torch.from_numpy(boxes).to(cuda), torch.from_numpy(valid).to(cuda)
    assert torch.equal(N.greedy_keep_cuda(b, v, 0.7),
                       N.greedy_keep_plain(b, v, 0.7))


@pytest.mark.cuda
def test_nms_kernel_repeats_and_replays(cuda):
    """The same launch twice gives equal masks, and so does its capture
    in a CUDAGraph replayed on new inputs copied into the same tensors."""
    from object_detection_tracking_tpu_torch.ops import nms as N
    from torch_nms_cases import path_case
    shape = (8, 5, 1000)
    cases = [[torch.from_numpy(x).to(cuda)
              for x in path_case(shape, seed=s)] for s in (1, 2)]
    b, v = (x.clone() for x in cases[0])
    first = N.greedy_keep_cuda(b, v, 0.7)
    assert torch.equal(first, N.greedy_keep_cuda(b, v, 0.7))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = N.greedy_keep_cuda.launches
    with torch.cuda.graph(graph):
        out = N.greedy_keep_cuda(b, v, 0.7)
    assert N.greedy_keep_cuda.launches == before + 1
    for boxes, valid in cases + cases[:1]:
        b.copy_(boxes)
        v.copy_(valid)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, N.greedy_keep_plain(boxes, valid, 0.7))
    assert not torch.equal(N.greedy_keep_plain(*cases[1], 0.7), first)


@pytest.mark.cuda
def test_nms_kernel_rejects_bad_arguments(cuda):
    from object_detection_tracking_tpu_torch.ops import nms as N
    b = torch.zeros(2, 10, 4, device=cuda)
    v = torch.ones(2, 10, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        N.greedy_keep_cuda(b.double(), v, 0.5)
    with pytest.raises(ValueError):
        N.greedy_keep_cuda(b, v.float(), 0.5)
    with pytest.raises(ValueError):
        N.greedy_keep_cuda(b[:, :9], v, 0.5)
    assert N.greedy_keep_cuda(b[:, :0], v[:, :0], 0.5).shape == (2, 0)
    # more boxes a group than one CTA's shared memory holds
    n = N.MAX_BOXES + 1
    with pytest.raises(ValueError):
        N.greedy_keep_cuda(torch.zeros(1, n, 4, device=cuda),
                           torch.ones(1, n, dtype=torch.bool, device=cuda),
                           0.5)
    with pytest.raises(RuntimeError):
        N.greedy_keep_plan(1, n, cuda)
    # a box view off 16 bytes is copied, not read misaligned
    flat = torch.rand(2 * 10 * 4 + 1, device=cuda) * 100
    off = flat[1:].view(2, 10, 4)
    off = torch.cat([off[..., :2], off[..., :2] + off[..., 2:]], -1)
    shifted = torch.empty(2 * 10 * 4 + 1, device=cuda)[1:].view(2, 10, 4)
    shifted.copy_(off)
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(N.greedy_keep_cuda(shifted, v, 0.3),
                       N.greedy_keep_plain(shifted, v, 0.3))


def sync_free_model(cfg, cuda, h, w, model_name=None):
    model = get_model(cfg, model_name)
    tree = init_params(cfg, seed=0, model_name=model_name or cfg.model)
    model = params_from_jax(tree, model).to(cuda).eval()
    imgs = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (2, h, w, 3)).astype(np.uint8)).to(cuda)
    return model, imgs


@pytest.mark.cuda
@pytest.mark.parametrize("model_name", ["faster_rcnn", "efficientdet"])
def test_forward_runs_no_host_sync(cuda, model_name):
    """The inference forwards on the card make no host sync (ROADMAP C7:
    NMS was the last): under ``set_sync_debug_mode("error")`` a forward
    after the first (which builds the per-size anchors) raises nothing.
    R50-FPN v4 with the mask head and the small-object heads with the
    person association; EfficientDet (efficientdet-test, B1's five-level
    launch)."""
    if model_name == "faster_rcnn":
        cfg = DetectorConfig.from_version(
            4, num_class=16, resnet_depth=50, short_edge_size=128,
            max_size=192, compute_dtype="bfloat16", add_mask=True,
            use_small_object_head=True, use_so_association=True)
        model, imgs = sync_free_model(cfg, cuda, 128, 192)
    else:
        cfg = DetectorConfig.coco(
            result_per_im=10, compute_dtype="bfloat16",
            efficientdet_name="efficientdet-test")
        model, imgs = sync_free_model(cfg, cuda, 96, 128, "efficientdet")
    model(imgs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model(imgs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in out.values()
               if t.is_floating_point())


@pytest.mark.cuda
def test_aot_compile_replays_the_exported_graph(cuda):
    """The packed forward on the card: the exported graph run eagerly
    equals the live forward, and its CUDA-graph capture (``aot_compile``)
    equals the exported graph run eagerly, bit for bit, for the params it
    was captured with, for a second params tree copied into its buffers,
    and for the first again."""
    from object_detection_tracking_tpu_torch.params import native_names
    from object_detection_tracking_tpu_torch.runtime import aot
    cfg = DetectorConfig.from_version(
        4, num_class=16, resnet_depth=50, short_edge_size=128, max_size=192,
        compute_dtype="bfloat16", add_mask=True)
    model, imgs = sync_free_model(cfg, cuda, 128, 192)
    names = native_names(model)
    state = dict(model.named_parameters())
    state.update(model.named_buffers())
    params = {n: state[a].detach().clone() for n, (a, _) in names.items()}
    forward = aot.ParamsForward(model, {n: a for n, (a, _) in names.items()})
    blob = aot.export_serialized(forward, params, imgs)
    call = aot.load_exported(blob, cuda)
    live = model(imgs)
    eager = call(params, imgs)
    for k in live:
        assert torch.equal(eager[k], live[k]), k
    replay = aot.aot_compile(call, params, imgs)
    other = {k: v * 1.01 for k, v in params.items()}
    eager2 = call(other, imgs)
    assert not torch.equal(eager2["final_probs"], eager["final_probs"])
    for p, ref in ((params, eager), (other, eager2), (params, eager)):
        got = replay(p, imgs)
        for k in ref:
            assert torch.equal(got[k], ref[k]), k
