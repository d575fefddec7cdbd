"""The port's ReID nets (models/reid: OSNet x0.25/x1.0, OSNet-IBN and -AIN,
ResNet 18/50/101, ResNeXt-50 and resnet50_fc512) against the JAX forwards
on the same weights: the port's seeded net saved as a torchreid ``.pth``,
read by JAX's own ``load_torch_state_dict``, both run in float32 on a
seeded [2, 64, 32] batch (the JAX forwards eager, un-jitted). Each name's
parameter count and state_dict key set are pinned: the JAX forwards read
their layout from the checkpoint's key names, so agreeing with them cannot
catch a layout that differs from torchreid's."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_tracking_tpu.models.reid import (osnet_ain_forward,
                                                       osnet_forward,
                                                       resnet_reid_forward)
from object_detection_tracking_tpu.models.reid.extractor import \
    load_torch_state_dict
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import close, reid_net

# name -> (parameters, state_dict entries, sha1 of the sorted keys). The
# ResNet counts are torchvision's published ones less the 1000-way fc
# (resnet18 11,689,512, resnet50 25,557,032, resnet101 44,549,160,
# resnext50_32x4d 25,028,904); resnet50_fc512 adds a 2048x512 fc and a
# 512-d BN1d; osnet_x1_0 is the OSNet paper's 2.2 M (Zhou et al., ICCV
# 2019); the IBN and AIN variants differ from it only in norms.
PINS = {
    "osnet_x0_25": (201864, 565, "1e66d0f46e3a517c"),
    "osnet_x1_0": (2169508, 565, "1e66d0f46e3a517c"),
    "osnet_ibn_x1_0": (2170532, 566, "b24e15edb03e793d"),
    "osnet_ain_x1_0": (2169508, 550, "000f98dfe05bf69e"),
    "resnet18": (11176512, 120, "c8cdd5d3edba2e2a"),
    "resnet50": (23508032, 318, "e57a49b1b851e55c"),
    "resnet101": (42500160, 624, "ec5414f7de57bc32"),
    "resnext50_32x4d": (22979904, 318, "e57a49b1b851e55c"),
    "resnet50_fc512": (24558144, 325, "64f212dc9c89d133"),
}
# keys (and shapes) that torchreid's constructors give each layout, and
# keys they do not: an IN stem has no running statistics; osnet_ibn_x1_0
# normalizes after the residual add in conv2's blocks only; in
# osnet_ain_x1_0 an OSBlockINin's conv3 has no BN, the streams are
# conv2.{t}.layers.{i} and the transitions pool2/pool3
LAYOUT = {
    "osnet_x0_25": ({"conv1.bn.running_mean": (16,),
                     "conv2.0.conv2d.3.conv2.weight": (16, 1, 3, 3),
                     "conv2.0.gate.fc1.weight": (1, 16, 1, 1),
                     "conv2.2.0.conv.weight": (64, 64, 1, 1),
                     "fc.0.weight": (512, 128)},
                    ("conv2.0.IN.weight", "conv4.2.0.conv.weight")),
    "osnet_x1_0": ({"conv3.0.downsample.conv.weight": (384, 256, 1, 1),
                    "conv3.2.0.bn.running_var": (384,),
                    "conv5.conv.weight": (512, 512, 1, 1),
                    "fc.1.running_var": (512,)},
                   ("conv4.1.downsample.bn.weight", "classifier.weight")),
    "osnet_ibn_x1_0": ({"conv1.bn.weight": (64,),
                        "conv2.0.IN.weight": (256,),
                        "conv2.1.IN.bias": (256,)},
                       ("conv1.bn.running_mean", "conv3.0.IN.weight",
                        "conv3.1.IN.weight", "conv4.0.IN.weight")),
    "osnet_ain_x1_0": ({"conv1.bn.weight": (64,),
                        "conv2.0.conv2.3.layers.3.conv2.weight":
                            (64, 1, 3, 3),
                        "conv2.0.IN.weight": (256,),
                        "conv3.0.conv3.bn.weight": (384,),
                        "conv3.1.IN.weight": (384,),
                        "conv4.0.IN.weight": (512,),
                        "pool2.0.conv.weight": (256, 256, 1, 1),
                        "pool3.0.bn.running_mean": (384,)},
                       ("conv1.bn.running_mean", "conv2.0.conv3.bn.weight",
                        "conv2.2.0.conv.weight", "conv3.0.IN.weight",
                        "conv4.1.IN.weight", "conv2.0.conv2a.conv1.weight")),
    "resnet18": ({"layer1.0.conv2.weight": (64, 64, 3, 3),
                  "layer2.0.downsample.0.weight": (128, 64, 1, 1)},
                 ("layer1.0.conv3.weight", "layer1.0.downsample.0.weight",
                  "fc.0.weight")),
    "resnet50": ({"layer1.0.conv3.weight": (256, 64, 1, 1),
                  "layer1.0.downsample.1.running_var": (256,),
                  "layer4.2.bn3.weight": (2048,)},
                 ("fc.0.weight",)),
    "resnet101": ({"layer3.22.conv2.weight": (256, 256, 3, 3)},
                  ("layer3.23.conv1.weight",)),
    "resnext50_32x4d": ({"layer1.0.conv2.weight": (128, 4, 3, 3),
                         "layer4.0.conv2.weight": (1024, 32, 3, 3)}, ()),
    "resnet50_fc512": ({"fc.0.weight": (512, 2048), "fc.0.bias": (512,),
                        "fc.1.running_mean": (512,)}, ("fc.2.weight",)),
}
FORWARDS = {"osnet_ain_x1_0": osnet_ain_forward}


def _jax_forward(name):
    if name in FORWARDS:
        return FORWARDS[name]
    if name.startswith("osnet"):
        return osnet_forward
    return lambda p, x: resnet_reid_forward(p, x, name)


@pytest.mark.parametrize("name", list(PINS))
def test_reid_net_layout_and_forward_match_jax(name, tmp_path):
    net = reid_net(name, seed=len(name))
    sd = net.state_dict()
    n_params, n_keys, digest = PINS[name]
    got_params = sum(p.numel() for p in net.parameters())
    if name == "osnet_x1_0":
        print(f"osnet_x1_0: {got_params} parameters (the OSNet paper, "
              "Zhou et al., ICCV 2019: 2.2 M)")
    assert got_params == n_params
    assert len(sd) == n_keys
    assert hashlib.sha1("\n".join(sorted(sd)).encode()).hexdigest()[
        :16] == digest
    present, absent = LAYOUT[name]
    for key, shape in present.items():
        assert tuple(sd[key].shape) == shape, key
    assert not set(absent) & set(sd)

    path = str(tmp_path / f"{name}.pth")
    torch.save(sd, path)
    params = {k: jnp.asarray(v) for k, v in load_torch_state_dict(
        path).items()}
    x = np.random.RandomState(len(name)).randn(2, 64, 32, 3).astype(
        np.float32)
    ref = np.asarray(_jax_forward(name)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, net.feature_dim)
    assert ref.shape == got.shape and np.isfinite(got).all()
    close(got, ref, rel=1e-4)
