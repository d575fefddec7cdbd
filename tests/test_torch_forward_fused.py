"""The port's whole forward with ``backbone_impl="pallas"`` against the
JAX forward with the same setting, at B=2 on the CPU in float32 (R50
partial-COCO: four stride-1 bottleneck tails, c2..c5). The JAX side runs
its Pallas stage kernel in interpret mode, jitted (BGR frames; eager, its
interpret mode takes ~30 s more), the port its plain stage version, which
is the kernel wrapper's CPU path. Equality rules as in
test_torch_forward.py (torch_port_common.compare_forward)."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu_torch.models import resnet as TR  # noqa: E402
from object_detection_tracking_tpu_torch.ops import resnet_stage as RS  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import (CONFIGS, H, W, compare_forward,  # noqa: E402
                               jax_params)


def test_forward_with_fused_backbone_matches_jax(monkeypatch):
    cfg = dataclasses.replace(CONFIGS["r50_partial_coco"](),
                              backbone_impl="pallas")
    imgs = np.random.RandomState(1).randint(0, 256, (2, H, W, 3)).astype(
        np.uint8)
    calls = []
    real = TR.fused_bottleneck_stage_cuda

    def counting(blocks, x, width, c_out):
        calls.append(len(blocks))
        return real(blocks, x, width, c_out)

    monkeypatch.setattr(TR, "fused_bottleneck_stage_cuda", counting)
    before = RS.fused_bottleneck_stage_cuda.launches
    compare_forward(cfg, jax_params(jax_model(cfg)), imgs, jit=True)
    assert calls == [3, 3, 5, 2]       # each group's stride-1 tail, once
    assert RS.fused_bottleneck_stage_cuda.launches == before   # CPU: plain
