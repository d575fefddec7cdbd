"""The port's ReID nets of six more families (models/reid: ShuffleNet v1,
PCB, ResNet-50-mid, MLFN, HA-CNN, MuDeep; ROADMAP A11b's second part)
against the JAX forwards on the same weights, as
tests/test_torch_reid_families.py holds the first six: the port's seeded
net saved as a torchreid ``.pth``, read by JAX's own
``load_torch_state_dict``, both run in float32 on a seeded batch of 2
(the JAX forward jitted once a model), within 1e-4 of the largest
magnitude. Input sizes: 64x32 for shufflenet, resnet50mid and mlfn (the
smallest these strides leave a 2x1 map at); 128x64 for PCB, whose 8x4
feature map 6 parts do not divide; the fixed 160x64 of hacnn and 256x128
of mudeep. Every name's parameter count, state_dict key count and key
digest are pinned, with keys and shapes of torchreid's layout. The
Cadene nets are in test_torch_reid_families_cadene.py."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_tracking_tpu.models.reid.extractor import \
    FORWARDS as JAX_FORWARDS
from object_detection_tracking_tpu.models.reid.extractor import \
    load_torch_state_dict
from object_detection_tracking_tpu_torch.models.reid.extractor import \
    build_reid_model
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import close, reid_net

# name -> (parameters, state_dict entries, sha1 of the sorted keys). PCB is
# torchvision's ResNet-50 (25,557,032 published, less its 2048x1000 fc:
# 23,508,032) plus the DimReduceLayer conv5 (a 2048x256 1x1 conv and a
# 256-d BN); resnet50mid is that trunk plus fc_fusion (4096x1024 + 1024
# and a 1024-d BN1d). mudeep's fc alone is 32768x4096 + 4096.
PINS = {
    "shufflenet": (904728, 294, "fbe9c2bd6b9398c7"),
    "pcb_p6": (24032832, 324, "5197e37a8e1d9130"),
    "pcb_p4": (24032832, 324, "5197e37a8e1d9130"),
    "resnet50mid": (27705408, 325, "d1e67fad1cd6528f"),
    "mlfn": (32473024, 667, "6c454c6e3331e5cf"),
    "hacnn": (2929112, 531, "b0f483a5ecd05bef"),
    "mudeep": (134940304, 172, "b263d816a593a954"),
}
# keys (and shapes) of torchreid's layouts, and keys they do not have:
# shufflenet's stage-2 entry 1x1 is not grouped and a stride-2 unit's
# conv3 gives out - in channels; PCB keeps the training-only conv5;
# MLFN's stem conv and fsm convs have biases, its factor convs not;
# HA-CNN's and MuDeep's ConvBlocks have conv biases
LAYOUT = {
    "shufflenet": ({"conv1.0.weight": (24, 3, 3, 3),
                    "stage2.0.conv1.weight": (60, 24, 1, 1),
                    "stage2.0.conv3.weight": (216, 20, 1, 1),
                    "stage2.1.conv2.weight": (60, 1, 3, 3),
                    "stage3.0.conv1.weight": (120, 80, 1, 1),
                    "stage3.0.conv3.weight": (240, 40, 1, 1),
                    "stage4.3.bn3.running_var": (960,)},
                   ("fc.0.weight", "stage2.4.conv1.weight")),
    "pcb_p6": ({"layer4.0.conv2.weight": (512, 512, 3, 3),
                "layer4.0.downsample.0.weight": (2048, 1024, 1, 1),
                "conv5.layers.0.weight": (256, 2048, 1, 1),
                "conv5.layers.1.running_mean": (256,)},
               ("fc.0.weight", "layer5.0.conv1.weight")),
    "resnet50mid": ({"fc_fusion.0.weight": (1024, 4096),
                     "fc_fusion.1.running_var": (1024,),
                     "layer4.2.conv3.weight": (2048, 512, 1, 1)},
                    ("fc.0.weight",)),
    "mlfn": ({"conv1.bias": (64,),
              "feature.0.fm_conv2.weight": (128, 4, 3, 3),
              "feature.0.fsm.1.weight": (128, 64, 1, 1),
              "feature.0.fsm.1.bias": (128,),
              "feature.0.fsm.7.weight": (32, 64, 1, 1),
              "feature.0.downsample.0.weight": (256, 64, 1, 1),
              "feature.3.downsample.0.weight": (512, 256, 1, 1),
              "feature.15.fm_conv3.weight": (2048, 1024, 1, 1),
              "fc_x.0.weight": (1024, 2048, 1, 1),
              "fc_s.0.weight": (1024, 512, 1, 1)},
             ("feature.1.downsample.0.weight", "fc_x.0.bias",
              "feature.0.fm_conv1.bias")),
    "hacnn": ({"conv.conv.weight": (32, 3, 3, 3), "conv.conv.bias": (32,),
               "inception1.0.stream4.1.conv.weight": (32, 32, 1, 1),
               "inception1.1.stream2.2.conv.weight": (32, 32, 3, 3),
               "inception1.1.stream3.1.conv.weight": (64, 128, 1, 1),
               "ha1.soft_attn.spatial_attn.conv1.conv.weight": (1, 1, 3, 3),
               "ha1.soft_attn.channel_attn.conv1.conv.weight":
                   (8, 128, 1, 1),
               "ha3.soft_attn.conv.bn.running_var": (384,),
               "ha3.hard_attn.fc.weight": (8, 384),
               "local_conv1.stream3.1.conv.weight": (64, 32, 1, 1),
               "local_conv3.stream1.0.conv.weight": (96, 256, 1, 1),
               "fc_global.0.weight": (512, 384),
               "fc_local.0.weight": (512, 1536)},
              ("classifier_global.weight", "classifier_local.weight")),
    "mudeep": ({"block1.conv1.conv.weight": (48, 3, 3, 3),
                "block1.conv1.conv.bias": (48,),
                "block2.stream4.2.conv.weight": (24, 24, 3, 3),
                "block3.stream3.2.conv.weight": (64, 56, 3, 3),
                "block4.stream2.1.conv.weight": (128, 64, 1, 3),
                "block4.stream4.4.conv.weight": (256, 128, 3, 1),
                "block5.a1": (1, 256, 1, 1),
                "fc.0.weight": (4096, 32768)},
               ("block2.stream2.0.weight", "classifier.weight")),
}
SIZE = {"pcb_p6": (128, 64), "pcb_p4": (128, 64), "hacnn": (160, 64),
        "mudeep": (256, 128)}


@pytest.mark.parametrize("name", list(PINS))
def test_reid_family_more_layout_matches_torchreid(name):
    torch.manual_seed(0)
    net = build_reid_model(name)
    sd = net.state_dict()
    n_params, n_keys, digest = PINS[name]
    assert sum(p.numel() for p in net.parameters()) == n_params
    assert len(sd) == n_keys
    assert hashlib.sha1("\n".join(sorted(sd)).encode()).hexdigest()[
        :16] == digest
    present, absent = LAYOUT.get(name, ({}, ()))
    for key, shape in present.items():
        assert tuple(sd[key].shape) == shape, key
    assert not set(absent) & set(sd)


@pytest.mark.parametrize("name", list(PINS))
def test_reid_family_more_forward_matches_jax(name, tmp_path):
    size = SIZE.get(name, (64, 32))
    net = reid_net(name, seed=len(name), size=size)
    if name == "hacnn":
        # torchreid starts the hard attention input-blind (zero fc
        # weights): give it weights, so that each image's part
        # translations differ and the affine sampling is exercised
        with torch.no_grad():
            g = torch.Generator().manual_seed(1)
            for i in (1, 2, 3):
                fc = getattr(net, f"ha{i}").hard_attn.fc
                fc.weight.copy_(torch.randn(fc.weight.shape, generator=g))
    path = str(tmp_path / f"{name}.pth")
    torch.save(net.state_dict(), path)
    params = {k: jnp.asarray(v) for k, v in load_torch_state_dict(
        path).items()}
    x = np.random.RandomState(len(name)).randn(2, *size, 3).astype(
        np.float32)
    ref = np.asarray(jax.jit(JAX_FORWARDS[name])(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, net.feature_dim)
    assert ref.shape == got.shape and np.isfinite(got).all()
    assert np.abs(got).max() > 0 and not np.allclose(got[0], got[1])
    close(got, ref, rel=1e-4)


def test_hacnn_and_mudeep_refuse_other_sizes():
    """Both nets are built for one input size (an assert in torchreid, a
    ValueError in both packages)."""
    for name, size in (("hacnn", (128, 64)), ("mudeep", (128, 64))):
        torch.manual_seed(0)
        net = build_reid_model(name).eval()
        with pytest.raises(ValueError, match="requires"):
            with torch.no_grad():
                net(torch.zeros(1, 3, *size))
