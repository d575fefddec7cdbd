"""EfficientDet training's device code on the card against the same calls
on the CPU. Every test needs a CUDA GPU (marker ``cuda``) and skips
without one; none needs JAX, so on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_effdet_train_cuda.py

``effdet_anchor_targets``: equal bit for bit (IoU, argmax and the force
match's scatter are exact; the encode takes its logs in float64).
``batch_bn``: float32 values and gradients within 1e-5 of their largest
magnitude (the same sums in another order); bf16 values within one bf16
step of the value plus that bound."""

import numpy as np
import pytest
import torch

from object_detection_tracking_tpu_torch.models.efficientdet import \
    effdet_anchors
from object_detection_tracking_tpu_torch.ops.norm import FrozenBN, batch_bn
from object_detection_tracking_tpu_torch.train.targets import \
    effdet_anchor_targets


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def gts(size, b, g, seed):
    """Random gts inside size x size with padded rows; in image 0 two
    copies of its first gt with another label (one best anchor written
    twice) and a box in the top-left corner, before the padded rows."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, size - 20, (b, g, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(size / 2), (b, g, 2)))
    boxes = np.concatenate([xy, np.minimum(xy + wh, size)], -1).astype(
        np.float32)
    labels = rng.randint(1, 16, (b, g)).astype(np.int32)
    valid = np.arange(g)[None, :] < rng.randint(0, g - 3, (b, 1))
    valid[0] = np.arange(g) < g // 2
    j = g // 2
    boxes[0, j:j + 2] = boxes[0, 0]
    labels[0, j:j + 2] = labels[0, 0] % 15 + 1
    boxes[0, j + 2] = (0, 0, 20, 20)
    valid[0, j:j + 3] = True
    boxes[~valid] = 0.0
    return boxes, labels, valid


@pytest.mark.cuda
@pytest.mark.parametrize("size,b,g,seed", [(512, 8, 100, 0),
                                            (128, 2, 8, 1),
                                            (640, 4, 30, 2)])
def test_effdet_anchor_targets_card_equals_cpu(cuda, size, b, g, seed):
    anchors = torch.from_numpy(np.concatenate([a.reshape(-1, 4) for a in
                                               effdet_anchors((size, size))]))
    batch = [torch.from_numpy(x) for x in gts(size, b, g, seed)]
    ref = effdet_anchor_targets(anchors, *batch)
    got = effdet_anchor_targets(anchors.to(cuda),
                                *[x.to(cuda) for x in batch])
    assert ref[2].any()
    for r, t in zip(ref, got):
        t = t.cpu()
        assert t.dtype == r.dtype
        if r.dtype == torch.float32:
            r, t = r.view(torch.int32), t.view(torch.int32)
        assert torch.equal(t, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_bn_card_matches_cpu(cuda, dtype):
    """channels_last NCHW input as the model gives it; in float32 also the
    gradients to x, gamma and beta of a random cotangent."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(3)
    x = torch.from_numpy((0.5 + 1.3 * rng.randn(8, 64, 32, 32))
                         .astype(np.float32)).to(dtype)
    ct = torch.from_numpy(rng.randn(8, 64, 32, 32).astype(np.float32))
    gamma = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    beta = torch.from_numpy(rng.randn(64).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        bn = FrozenBN(64).to(dev)
        with torch.no_grad():
            bn.gamma.copy_(gamma)
            bn.beta.copy_(beta)
        bn.requires_grad_(True)
        xt = x.to(dev).contiguous(memory_format=torch.channels_last)
        xt.requires_grad_(True)
        y = batch_bn(bn, xt)
        y.float().backward(ct.to(dev))
        out[dev] = [t.detach().float().cpu() for t in
                    (y, xt.grad, bn.gamma.grad, bn.beta.grad)]
    checks = zip(out["cpu"], out["cuda"])
    if dtype == torch.bfloat16:           # the values, rounded once
        r, t = next(checks)
        assert torch.all((t - r).abs() <= 1e-5 * r.abs().max()
                         + r.abs() * 2.0 ** -7)
        return
    for i, (r, t) in enumerate(checks):
        assert torch.all((t - r).abs() <= 1e-5 * r.abs().max()), i
