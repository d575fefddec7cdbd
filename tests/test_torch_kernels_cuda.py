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
intermediate that lands the other way moves everything after it."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from object_detection_tracking_tpu_torch.config import DetectorConfig
from object_detection_tracking_tpu_torch.models import get_model
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
    with pytest.raises(ValueError):
        RA.multilevel_roi_align_cuda(feats[:3], boxes, STRIDES[:3], 7)


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
