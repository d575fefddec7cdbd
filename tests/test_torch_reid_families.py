"""The port's ReID nets of six more families (models/reid: SENet,
IBN-Net, MobileNetV2, DenseNet, SqueezeNet, ShuffleNetV2; ROADMAP A11b's
first part) against the JAX forwards on the same weights, as
tests/test_torch_reid_models.py holds OSNet and ResNet: the port's seeded
net saved as a torchreid ``.pth``, read by JAX's own
``load_torch_state_dict``, both run in float32 on a seeded [2, 64, 32]
batch (the JAX forwards eager). Every name's parameter count, state_dict
key count and key digest are pinned, with keys and shapes of torchreid's
layout, because the JAX forwards read their structure from the key
names. A file of its own, so that ``--dist loadfile`` runs it beside the
OSNet/ResNet file."""

import hashlib

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
from torch_port_common import close, reid_net

# name -> (parameters, state_dict entries, sha1 of the sorted keys). Where
# torchreid builds torchvision's layout the count is torchvision's
# published total less its 1000-way classifier: densenet121 7,978,856,
# densenet169 14,149,480, densenet201 20,013,928, densenet161 28,681,000;
# squeezenet1_0 1,248,424 and squeezenet1_1 1,235,496 (a 512x1000 1x1
# conv); shufflenet_v2_x0_5 1,366,792, x1_0 2,278,604, x1_5 3,503,624,
# x2_0 7,393,996 (torchvision's model docs). The SENets are the Cadene
# SENet's totals less the 2048x1000 last_linear: se_resnet50 28,088,024,
# se_resnet101 49,326,872, se_resnext50_32x4d 27,559,896,
# se_resnext101_32x4d 48,955,416 (the pretrainedmodels package); the fc512
# heads add a 2048x512 (densenet121: 1024x512, squeezenet: 512x512) fc and
# a 512-d BN1d. resnet50_ibn_a has resnet50's count (an IN's affine
# replaces half of a BN's); ibn_b adds the affines of two post-add INs
# (256 and 512 channels). mobilenetv2_x1_0 is torchvision's mobilenet_v2
# (3,504,872 less 1,281,000) plus 1,088: torchreid's first bottleneck
# keeps a 32->32 1x1 expansion ConvBlock (1,024 weights, a 32-d BN) that
# torchvision drops at expansion 1.
PINS = {
    "se_resnet50": (26039024, 382, "fa27a109938ca9e1"),
    "se_resnet50_fc512": (27089136, 389, "a3051ad7e3830c28"),
    "se_resnet101": (47277872, 756, "649ff58c3eaff7d8"),
    "se_resnext50_32x4d": (25510896, 382, "fa27a109938ca9e1"),
    "se_resnext101_32x4d": (46906416, 756, "649ff58c3eaff7d8"),
    "resnet50_ibn_a": (23508032, 344, "174e13d884f009c4"),
    "resnet50_ibn_b": (23509568, 319, "131c395535a7d515"),
    "mobilenetv2_x1_0": (2224960, 318, "74a8ad2a482ba2bc"),
    "mobilenetv2_x1_4": (4291604, 318, "74a8ad2a482ba2bc"),
    "densenet121": (6953856, 725, "e76c007450fb53a8"),
    "densenet169": (12484480, 1013, "677ece2c8177e407"),
    "densenet201": (18092928, 1205, "8370756cf1ff9d1e"),
    "densenet161": (26472000, 965, "f69a0412160f10f0"),
    "densenet121_fc512": (7479680, 732, "a3b2761b09611b58"),
    "squeezenet1_0": (735424, 50, "de397d134a172194"),
    "squeezenet1_0_fc512": (999104, 57, "bab5477fc62aa68d"),
    "squeezenet1_1": (722496, 50, "736a10806f2976de"),
    "shufflenet_v2_x0_5": (341792, 336, "61fadb16dd37b11e"),
    "shufflenet_v2_x1_0": (1253604, 336, "61fadb16dd37b11e"),
    "shufflenet_v2_x1_5": (2478624, 336, "61fadb16dd37b11e"),
    "shufflenet_v2_x2_0": (5344996, 336, "61fadb16dd37b11e"),
}
# keys (and shapes) of torchreid's layouts, and keys they do not have:
# se_resnet strides its 1x1 conv1 and se_resnext its grouped conv2 (the
# shapes cannot tell; the forward test does); an IN has no running
# statistics; ibn_a's IBN halves bn1 in layers 1-3 only; ibn_b's IN sits
# after the add of the last block of layers 1-2; a stride-1 shuffle unit
# has no branch1; squeezenet's slots follow its version
LAYOUT = {
    "se_resnet50": ({"layer0.conv1.weight": (64, 3, 7, 7),
                     "layer1.0.se_module.fc1.weight": (16, 256, 1, 1),
                     "layer1.0.se_module.fc2.bias": (256,),
                     "layer2.0.conv1.weight": (128, 256, 1, 1),
                     "layer4.0.downsample.0.weight": (2048, 1024, 1, 1)},
                    ("conv1.weight", "fc.0.weight")),
    "se_resnet50_fc512": ({"fc.0.weight": (512, 2048),
                           "fc.1.running_var": (512,)}, ()),
    "se_resnext50_32x4d": ({"layer1.0.conv1.weight": (128, 64, 1, 1),
                            "layer1.0.conv2.weight": (128, 4, 3, 3),
                            "layer4.2.conv2.weight": (1024, 32, 3, 3)}, ()),
    "resnet50_ibn_a": ({"layer1.0.bn1.IN.weight": (32,),
                        "layer1.0.bn1.BN.running_mean": (32,),
                        "layer3.5.bn1.IN.bias": (128,),
                        "layer4.0.bn1.running_var": (512,),
                        "bn1.running_mean": (64,)},
                       ("layer4.0.bn1.IN.weight", "layer1.0.bn1.weight")),
    "resnet50_ibn_b": ({"bn1.weight": (64,), "layer1.2.IN.weight": (256,),
                        "layer2.3.IN.bias": (512,)},
                       ("bn1.running_mean", "layer1.0.IN.weight",
                        "layer3.5.IN.weight", "layer2.3.IN.running_mean")),
    "mobilenetv2_x1_0": ({"conv1.conv.weight": (32, 3, 3, 3),
                          "conv2.0.conv1.conv.weight": (32, 32, 1, 1),
                          "conv2.0.dwconv2.conv.weight": (32, 1, 3, 3),
                          "conv2.0.conv3.0.weight": (16, 32, 1, 1),
                          "conv8.0.conv3.1.running_var": (320,),
                          "conv9.conv.weight": (1280, 320, 1, 1)},
                         ("fc.0.weight",)),
    "mobilenetv2_x1_4": ({"conv1.conv.weight": (44, 3, 3, 3),
                          "conv5.3.conv3.0.weight": (89, 534, 1, 1),
                          "conv9.bn.weight": (1792,)}, ()),
    "densenet121": ({"features.conv0.weight": (64, 3, 7, 7),
                     "features.denseblock1.denselayer1.conv1.weight":
                         (128, 64, 1, 1),
                     "features.denseblock1.denselayer6.conv2.weight":
                         (32, 128, 3, 3),
                     "features.transition1.conv.weight": (128, 256, 1, 1),
                     "features.norm5.running_mean": (1024,)},
                    ("features.transition4.conv.weight", "fc.0.weight")),
    "densenet161": ({"features.conv0.weight": (96, 3, 7, 7),
                     "features.denseblock3.denselayer36.conv2.weight":
                         (48, 192, 3, 3),
                     "features.norm5.weight": (2208,)}, ()),
    "squeezenet1_0": ({"features.0.weight": (96, 3, 7, 7),
                       "features.0.bias": (96,),
                       "features.3.squeeze.weight": (16, 96, 1, 1),
                       "features.12.expand3x3.weight": (256, 64, 3, 3)},
                      ("features.6.squeeze.weight", "fc.0.weight")),
    "squeezenet1_1": ({"features.0.weight": (64, 3, 3, 3),
                       "features.6.expand1x1.bias": (128,),
                       "features.12.squeeze.weight": (64, 512, 1, 1)},
                      ("features.5.squeeze.weight",
                       "features.8.squeeze.weight")),
    "squeezenet1_0_fc512": ({"fc.0.weight": (512, 512)}, ()),
    "shufflenet_v2_x1_0": ({"conv1.0.weight": (24, 3, 3, 3),
                            "stage2.0.branch1.0.weight": (24, 1, 3, 3),
                            "stage2.0.branch1.2.weight": (58, 24, 1, 1),
                            "stage2.0.branch2.0.weight": (58, 24, 1, 1),
                            "stage2.1.branch2.0.weight": (58, 58, 1, 1),
                            "stage4.3.branch2.3.weight": (232, 1, 3, 3),
                            "conv5.0.weight": (1024, 464, 1, 1)},
                           ("stage2.1.branch1.0.weight",
                            "stage3.8.branch2.0.weight")),
    "shufflenet_v2_x2_0": ({"conv5.1.running_var": (2048,)}, ()),
}
# one forward per family, and the variants whose structure differs: the
# fc heads, se_resnext's stride, ibn_b, squeezenet v1.1 and mobilenet's
# x1.4 widths
FORWARD = ("se_resnet50_fc512", "se_resnext50_32x4d", "resnet50_ibn_a",
           "resnet50_ibn_b", "mobilenetv2_x1_4", "densenet121_fc512",
           "squeezenet1_0", "squeezenet1_1", "shufflenet_v2_x0_5")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(PINS))
def test_reid_family_layout_matches_torchreid(name):
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


@pytest.mark.parametrize("name", FORWARD)
def test_reid_family_forward_matches_jax(name, tmp_path):
    net = reid_net(name, seed=len(name))
    path = str(tmp_path / f"{name}.pth")
    torch.save(net.state_dict(), path)
    params = {k: jnp.asarray(v) for k, v in load_torch_state_dict(
        path).items()}
    x = np.random.RandomState(len(name)).randn(2, 64, 32, 3).astype(
        np.float32)
    ref = np.asarray(JAX_FORWARDS[name](params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, net.feature_dim)
    assert ref.shape == got.shape and np.isfinite(got).all()
    assert np.abs(got).max() > 0 and not np.allclose(got[0], got[1])
    close(got, ref, rel=1e-4)
