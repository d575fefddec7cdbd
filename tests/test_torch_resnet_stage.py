"""The port's bottleneck stage (ops/resnet_stage.py) against the JAX
package's Pallas ``fused_bottleneck_stage``, run as its own tests run it on
the CPU (interpret mode), with the cases of test_resnet_stage_pallas.py:
1-3 blocks, an identity tail, a first-block shortcut conv, the image edge
rows, non-trivial frozen-BN statistics. float32 within 2e-5 of the
reference's largest magnitude (the JAX tests' own bound); bf16 within 2e-2
of it (ditto). Also: the folded weights, the CPU dispatcher, and the
backbone gate of ResNet(fused_stages=True)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from object_detection_tracking_tpu.models.resnet import (  # noqa: E402
    init_bottleneck, resnet_c2345)
from object_detection_tracking_tpu.ops.pallas import (  # noqa: E402
    resnet_stage_pallas as JS)
from object_detection_tracking_tpu_torch.models import resnet as TR  # noqa: E402
from object_detection_tracking_tpu_torch.models.resnet import (  # noqa: E402
    Bottleneck, ResNet)
from object_detection_tracking_tpu_torch.ops import resnet_stage as RS  # noqa: E402
from object_detection_tracking_tpu_torch.params import params_from_jax  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import close  # noqa: E402


def jiggle_bn(tree, rng):
    """Non-trivial frozen-BN statistics (identity ones hide sign and offset
    bugs in the folding), from numpy."""
    for k, v in tree.items():
        if k == "bn":
            c = v["mean"].shape[0]
            v["mean"] = (rng.randn(c) * 0.1).astype(np.float32)
            v["variance"] = (np.abs(rng.randn(c)) + 0.5).astype(np.float32)
            v["gamma"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
            v["beta"] = (0.05 * rng.randn(c)).astype(np.float32)
        elif isinstance(v, dict):
            jiggle_bn(v, rng)


def make_blocks(n, c_in, width, seed=0):
    """(JAX block dicts, the port's Bottleneck modules) with equal
    weights."""
    ks = jax.random.split(jax.random.PRNGKey(seed), n)
    tree, mods, c = {}, nn.ModuleDict(), c_in
    for i in range(n):
        tree[f"block{i}"] = jax.tree.map(
            np.asarray, init_bottleneck(ks[i], c, width, False, False))
        mods[f"block{i}"] = Bottleneck(c, width, 1, 1, False, False)
        c = 4 * width
    jiggle_bn(tree, np.random.RandomState(seed + 100))
    params_from_jax(tree, mods)
    return [tree[f"block{i}"] for i in range(n)], list(mods.values())


def run_both(jb, tb, x, width):
    ref = JS.fused_bottleneck_stage(jb, jnp.asarray(x), width, 4 * width)
    got = RS.fused_bottleneck_stage(tb, torch.from_numpy(np.asarray(x)),
                                    width, 4 * width)
    return np.asarray(ref, np.float32), got.float().numpy()


def f32_tol(ref):
    return 2e-5 * max(1.0, float(np.abs(ref).max()))


def normal(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("n_blocks", [1, 2, 3])
def test_plain_stage_matches_jax_f32(n_blocks):
    jb, tb = make_blocks(n_blocks, 64, 16)
    ref, got = run_both(jb, tb, normal((2, 16, 24, 64), 7), 16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=f32_tol(ref))


def test_plain_stage_first_block_shortcut():
    jb, tb = make_blocks(2, 32, 16, seed=1)
    assert "convshortcut" in jb[0] and tb[0].convshortcut is not None
    ref, got = run_both(jb, tb, normal((1, 12, 16, 32), 5), 16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=f32_tol(ref))


def test_plain_stage_identity_tail():
    jb, tb = make_blocks(3, 32, 16, seed=2)
    ref, got = run_both(jb[1:], tb[1:], normal((1, 8, 16, 64), 5), 16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=f32_tol(ref))


def test_plain_stage_edge_rows_are_exact():
    """The 3x3 must see zeros beyond the image edge, not relu(bias)."""
    jb, tb = make_blocks(3, 64, 16, seed=3)
    ref, got = run_both(jb, tb, normal((1, 12, 16, 64), 11), 16)
    d = np.abs(ref - got)
    tol = f32_tol(ref)
    assert d[:, :3].max() <= tol and d[:, -3:].max() <= tol
    assert d[:, :, :3].max() <= tol and d[:, :, -3:].max() <= tol


def test_plain_stage_matches_jax_bf16():
    jb, tb = make_blocks(3, 64, 16)
    x = jnp.asarray(normal((1, 16, 24, 64), 3), jnp.bfloat16)
    ref = np.asarray(JS.fused_bottleneck_stage(jb, x, 16, 64), np.float32)
    got = RS.fused_bottleneck_stage(
        tb, torch.from_numpy(np.asarray(x, np.float32)).bfloat16(), 16, 64)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 0.02 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prepare_stage_weights_match_jax(dtype):
    jb, tb = make_blocks(2, 32, 16, seed=4)
    ref, ref_sc = JS.prepare_stage_weights(jb, getattr(jnp, dtype))
    got, got_sc = RS.prepare_stage_weights(tb, getattr(torch, dtype))
    assert got_sc == ref_sc == [True, False]
    assert len(got) == len(ref) == 14
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        r = r.reshape(r.shape[-1]) if r.ndim == 3 else r    # biases
        assert g.dtype == (torch.float32 if r.ndim == 1
                           else getattr(torch, dtype))
        np.testing.assert_allclose(g.float().numpy(), r, rtol=1e-6,
                                   atol=1e-7)


def test_cpu_dispatcher_takes_the_plain_version():
    _, tb = make_blocks(2, 64, 16)
    x = torch.from_numpy(normal((1, 8, 12, 64), 1))
    before = RS.fused_bottleneck_stage_cuda.launches
    got = RS.fused_bottleneck_stage_cuda(tb, x, 16, 64)
    assert RS.fused_bottleneck_stage_cuda.launches == before == 0
    assert torch.equal(got, RS.fused_bottleneck_stage(tb, x, 16, 64))


def test_folded_weights_follow_reloaded_params():
    """A stage run, then new weights copied in (params_from_jax): the next
    run folds the new ones, not the cached old ones."""
    jb, tb = make_blocks(2, 64, 16, seed=5)
    x = torch.from_numpy(normal((1, 8, 12, 64), 2))
    first = RS.fused_bottleneck_stage(tb, x, 16, 64)
    jb2, _ = make_blocks(2, 64, 16, seed=6)
    mods = nn.ModuleDict({f"block{i}": b for i, b in enumerate(tb)})
    params_from_jax({f"block{i}": b for i, b in enumerate(jb2)}, mods)
    again = RS.fused_bottleneck_stage(tb, x, 16, 64)
    assert not torch.equal(first, again)
    _, fresh = make_blocks(2, 64, 16, seed=6)
    assert torch.equal(again, RS.fused_bottleneck_stage(fresh, x, 16, 64))


def test_fused_backbone_matches_jax_gate(monkeypatch):
    """ResNet(fused_stages=True) at R50 against the JAX resnet_c2345 with
    fused_stages=True, c2..c5; one stage call per group (4 at R50, the
    stride-2 lead blocks unfused), 3 at R101 with dilated c5, none for a
    basic-block, SE or ResNeXt net."""
    jm_params = _r50_params()
    calls = []
    real = TR.fused_bottleneck_stage_cuda

    def counting(blocks, x, width, c_out):
        calls.append(len(blocks))
        return real(blocks, x, width, c_out)

    monkeypatch.setattr(TR, "fused_bottleneck_stage_cuda", counting)
    net = params_from_jax(jm_params, ResNet((3, 4, 6, 3), False,
                                            fused_stages=True))
    img = normal((1, 64, 96, 3), 9) * 0.5
    ref = resnet_c2345(jm_params, jnp.asarray(img), (3, 4, 6, 3), freeze=-1,
                       fused_stages=True)
    with torch.inference_mode():
        got = net(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert calls == [3, 3, 5, 2]
    for g, r in zip(got, ref):
        assert g.permute(0, 2, 3, 1).is_contiguous()
        close(g.permute(0, 2, 3, 1), np.asarray(r))
    assert ResNet((3, 4, 23, 3), False, use_dilations=True,
                  fused_stages=True).fused_groups == [0, 1, 2]
    for kw in (dict(use_basic_block=True), dict(use_se=True),
               dict(use_resnext=True)):
        basic = kw.pop("use_basic_block", False)
        assert ResNet((2, 2, 2, 2), basic, fused_stages=True,
                      **kw).fused_groups == []


def _r50_params():
    from object_detection_tracking_tpu.models.resnet import init_resnet
    tree = jax.tree.map(np.asarray, init_resnet(jax.random.PRNGKey(0),
                                                (3, 4, 6, 3), False))
    for gname, group in tree.items():
        if gname.startswith("group"):
            for blk in group.values():
                blk["conv3"]["bn"]["gamma"] = blk["conv3"]["bn"]["gamma"] * 0.2
    return tree
