"""The port's Mask R-CNN pieces against the JAX package on the CPU in
float32: the 2x2/2 transposed conv (with an asymmetric kernel, which a
merely permuted F.conv_transpose2d weight gets wrong), the up-4-conv head,
the whole forward with ``add_mask``, the ``maskrcnn`` params both ways,
the JAX-free init, and the runner's bf16-rounded mask readback."""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from object_detection_tracking_tpu.config import DetectorConfig  # noqa: E402
from object_detection_tracking_tpu.models import heads as jheads  # noqa: E402
from object_detection_tracking_tpu.models import layers as jlayers  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.models.heads import (  # noqa: E402
    MaskRCNNUp4ConvHead)
from object_detection_tracking_tpu_torch.models.layers import (  # noqa: E402
    Conv, deconv2d)
from object_detection_tracking_tpu_torch.params import (  # noqa: E402
    init_params, params_from_jax, params_to_jax)
from object_detection_tracking_tpu_torch.runtime import DetectionRunner  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import (CONFIGS, H, W, close,  # noqa: E402
                               compare_forward, jax_params)

CFG = dict(num_class=5, resnet_depth=18, short_edge_size=64, max_size=96,
           compute_dtype="float32", add_mask=True)


def flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def test_deconv2d_matches_jax_with_an_asymmetric_kernel():
    rng = np.random.RandomState(0)
    params = {"W": rng.randn(2, 2, 6, 5).astype(np.float32),     # HWIO
              "b": rng.randn(5).astype(np.float32)}
    # every tap different: a kernel that is not flipped, or in/out not
    # swapped, lands each tap on the wrong output pixel or channel
    assert not np.allclose(params["W"], params["W"][::-1, ::-1])
    x = rng.randn(3, 7, 9, 6).astype(np.float32)
    ref = np.asarray(jlayers.deconv2d(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        stride=2))
    mod = Conv(2, 6, 5)
    params_from_jax(params, mod)
    got = deconv2d(mod, nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (3, 14, 18, 5)
    close(got.detach(), ref, rel=1e-6)


def test_mask_head_matches_jax():
    params = jax.tree.map(np.asarray, jheads.init_maskrcnn_head(
        jax.random.PRNGKey(0), 5, 32, 16))
    head = params_from_jax(params, MaskRCNNUp4ConvHead(5, 32, 16))
    x = np.random.RandomState(1).randn(4, 14, 14, 32).astype(np.float32)
    ref = np.asarray(jheads.maskrcnn_up4conv_head(params, jnp.asarray(x), 5))
    with torch.inference_mode():
        got = head(torch.from_numpy(x))
    assert got.shape == ref.shape == (4, 28, 28, 4)
    close(got, ref, rel=1e-5)


def test_maskrcnn_params_round_trip_is_bit_exact():
    """On the port's init_params tree, which has the JAX tree's structure
    (next test) and is quicker to build."""
    cfg = DetectorConfig(**CFG)
    tree = init_params(cfg, seed=2)
    assert sorted(tree["maskrcnn"]) == ["conv", "deconv", "fcn0", "fcn1",
                                        "fcn2", "fcn3"]
    model = params_from_jax(tree, get_model(cfg))
    w = tree["maskrcnn"]["deconv"]["W"]
    assert np.array_equal(model.maskrcnn.deconv.weight.detach().numpy(),
                          w.transpose(3, 2, 0, 1))
    back = dict(flatten(params_to_jax(model)))
    ref = dict(flatten(tree))
    assert sorted(back) == sorted(ref)
    for k in ref:
        assert back[k].dtype == ref[k].dtype
        assert np.array_equal(back[k], ref[k]), k


def test_init_params_mask_head_shapes_and_fan_out():
    cfg = DetectorConfig(**CFG)
    ref = dict(flatten(jax.eval_shape(jax_model(cfg).init_params,
                                      jax.random.PRNGKey(0))))
    tree = init_params(cfg, seed=0)
    got = dict(flatten(tree))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    # msra_fanout: truncated normal, std sqrt(2 / (k * k * c_out))
    w = tree["maskrcnn"]["fcn1"]["W"]                      # 3x3, 256 -> 256
    std = np.sqrt(2.0 / (9 * 256)) / .87962566103423978
    assert np.abs(w).max() <= 2 * std + 1e-7
    assert abs(w.std() / (0.87962566 * std) - 1) < 0.02
    assert not tree["maskrcnn"]["conv"]["b"].any()


def test_forward_with_masks_matches_jax():
    """The whole forward with add_mask (R50 v4, class-agnostic box head)
    against the eager JAX forward, B=2, float32: the detections as in
    test_torch_forward.py, and final_masks to 1e-5. The mask head's last
    conv is scaled by 0.05 for this: its random msra weights give logits
    up to ~115, where the sigmoid is 0 or 1 almost everywhere and a float32
    rounding of the logit (~3e-4 at that size) says nothing; scaled, the
    logits stay within ~6 and the masks spread over (0, 1)."""
    cfg = dataclasses.replace(CONFIGS["r50_v4"](), add_mask=True)
    params = jax_params(jax_model(cfg))
    params["maskrcnn"]["conv"]["W"] = params["maskrcnn"]["conv"]["W"] * 0.05
    imgs = np.random.RandomState(1).randint(0, 256, (2, H, W, 3)).astype(
        np.uint8)
    got, ref = compare_forward(cfg, params, imgs)
    m, valid = ref["final_masks"], ref["final_valid"]
    assert got["final_masks"].shape == m.shape == (2, 8, 28, 28)
    assert ((m[valid] > 0.05) & (m[valid] < 0.95)).mean() > 0.2
    np.testing.assert_allclose(got["final_masks"], m, atol=1e-5, rtol=0)


class MaskModel(nn.Module):
    """A 'detector' with masks whose values need more than bf16's 8 bits."""

    device = torch.device("cpu")

    def forward(self, images):
        b = images.shape[0]
        val = images.reshape(b, -1).float().mean(dim=1) / 255.0
        masks = torch.linspace(0, 1, 28 * 28).reshape(1, 1, 28, 28) \
            * val[:, None, None, None] + 1e-3
        return {"final_boxes": torch.zeros(b, 2, 4),
                "final_labels": torch.ones(b, 2, dtype=torch.int32),
                "final_probs": torch.ones(b, 2),
                "final_valid": torch.ones(b, 2, dtype=torch.bool),
                "pooled_box_feat": torch.zeros(b, 2, 8),
                "final_masks": masks.expand(b, 2, 28, 28).contiguous()}


def test_runner_ships_bf16_rounded_masks():
    rng = np.random.RandomState(0)
    imgs = [rng.randint(0, 256, (2, 6, 8, 3)).astype(np.uint8)
            for _ in range(3)]
    model = MaskModel()
    got = list(DetectionRunner(model).run((x, i) for i, x in enumerate(imgs)))
    for (out, i), x in zip(got, imgs):
        ref = model(torch.from_numpy(x))["final_masks"]
        assert out["final_masks"].dtype == np.float32
        assert out["final_masks"].shape == (2, 2, 28, 28)
        np.testing.assert_array_equal(out["final_masks"],
                                      ref.bfloat16().float().numpy())
        assert not np.array_equal(out["final_masks"], ref.numpy())
