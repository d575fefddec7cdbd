"""The port's ReID nets of the four Cadene families (models/reid:
Xception, Inception-v4, Inception-ResNet-v2, NASNet-A-Mobile; ROADMAP
A11b's last part) against the JAX forwards on the same weights, as
test_torch_reid_families_more.py holds the others: the port's seeded net
saved as a torchreid ``.pth``, read by JAX's ``load_torch_state_dict``,
both run in float32 on a seeded batch of 2 (the JAX forward jitted once a
model), within 1e-4 of the largest magnitude. Input sizes: 64x32 for
xception and nasnetamobile; 96x80 for the Inception nets, whose unpadded
stems and valid-padded reductions need 75 pixels a side. Inception-v4
measures its BN statistics with every BN beta at 1 (``reid_net``: with
beta 0 the random net is chaotic, its float32 forward 3e-5 of the
output's magnitude from float64 at 96x80). Each name's parameter count is the Cadene
``pretrainedmodels`` total less its 1000-way ``last_linear``: xception
22,855,952 - 2,049,000, inceptionv4 42,679,816 - 1,537,000,
inceptionresnetv2 55,843,464 - 1,537,000, nasnetamobile 5,289,978 -
1,057,000; with key counts, key digests and torchreid's keys and
shapes."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from object_detection_tracking_tpu.models.reid.extractor import \
    FORWARDS as JAX_FORWARDS
from object_detection_tracking_tpu.models.reid.extractor import \
    load_torch_state_dict
from object_detection_tracking_tpu_torch.models.reid.extractor import \
    build_reid_model
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import close, reid_net

PINS = {
    "xception": (20806952, 274, "bb04567b6a3651fd"),
    "inceptionv4": (41142816, 894, "733d0790f20d5e01"),
    "inceptionresnetv2": (54306464, 1304, "6add2a03cb18561a"),
    "nasnetamobile": (4232978, 1316, "cea6964c6d360813"),
    "nasnsetmobile": (4232978, 1316, "cea6964c6d360813"),
}
# BN eps of each net (the Cadene graphs' 1e-3, torchreid's xception 1e-5)
BN_EPS = {"xception": 1e-5, "inceptionv4": 1e-3, "inceptionresnetv2": 1e-3,
          "nasnetamobile": 1e-3, "nasnsetmobile": 1e-3}
# xception's rep indices shift with start_with_relu (block1 has none) and
# grow_first (block12 widens last); the Inception convs have no bias, the
# residual projections do; NASNet's paths and reduction cells
LAYOUT = {
    "xception": ({"conv1.weight": (32, 3, 3, 3),
                  "block1.rep.0.conv1.weight": (64, 1, 3, 3),
                  "block1.rep.0.pointwise.weight": (128, 64, 1, 1),
                  "block1.rep.1.running_var": (128,),
                  "block1.rep.3.pointwise.weight": (128, 128, 1, 1),
                  "block2.rep.1.conv1.weight": (128, 1, 3, 3),
                  "block2.rep.4.pointwise.weight": (256, 256, 1, 1),
                  "block4.rep.7.pointwise.weight": (728, 728, 1, 1),
                  "block12.rep.1.pointwise.weight": (728, 728, 1, 1),
                  "block12.rep.4.pointwise.weight": (1024, 728, 1, 1),
                  "block12.skip.weight": (1024, 728, 1, 1),
                  "conv4.pointwise.weight": (2048, 1536, 1, 1)},
                 ("block4.skip.weight", "block1.rep.2.weight",
                  "fc.0.weight")),
    "inceptionv4": ({"features.0.conv.weight": (32, 3, 3, 3),
                     "features.3.conv.conv.weight": (96, 64, 3, 3),
                     "features.4.branch1.1.conv.weight": (64, 64, 1, 7),
                     "features.6.branch3.1.conv.weight": (96, 384, 1, 1),
                     "features.10.branch1.2.conv.weight": (256, 224, 3, 3),
                     "features.17.branch2.4.conv.weight": (256, 224, 1, 7),
                     "features.18.branch1.3.conv.weight": (320, 320, 3, 3),
                     "features.21.branch2_3b.conv.weight": (256, 512, 3, 1)},
                    ("features.0.conv.bias",
                     "features.22.branch0.conv.weight")),
    "inceptionresnetv2": ({"conv2d_1a.conv.weight": (32, 3, 3, 3),
                           "mixed_5b.branch1.1.conv.weight": (64, 48, 5, 5),
                           "repeat.9.conv2d.weight": (320, 128, 1, 1),
                           "repeat.9.conv2d.bias": (320,),
                           "repeat_1.19.branch1.2.conv.weight":
                               (192, 160, 7, 1),
                           "repeat_2.8.conv2d.bias": (2080,),
                           "block8.conv2d.weight": (2080, 448, 1, 1),
                           "conv2d_7b.conv.weight": (1536, 2080, 1, 1)},
                          ("conv2d_1a.conv.bias", "repeat_2.9.conv2d.weight")),
    "nasnetamobile": ({
        "conv0.conv.weight": (32, 3, 3, 3),
        "cell_stem_0.conv_1x1.conv.weight": (11, 32, 1, 1),
        "cell_stem_0.comb_iter_0_right.separable_1.depthwise_conv2d.weight":
            (32, 1, 7, 7),
        "cell_stem_0.comb_iter_0_right.separable_1.pointwise_conv2d.weight":
            (11, 32, 1, 1),
        "cell_stem_1.conv_1x1.conv.weight": (22, 44, 1, 1),
        "cell_stem_1.path_2.conv.weight": (11, 32, 1, 1),
        "cell_stem_1.final_path_bn.running_var": (22,),
        "cell_0.path_1.conv.weight": (22, 44, 1, 1),
        "cell_1.conv_prev_1x1.conv.weight": (44, 88, 1, 1),
        "cell_6.conv_1x1.conv.weight": (88, 352, 1, 1),
        "reduction_cell_0.comb_iter_0_right.separable_1.depthwise_conv2d."
        "weight": (88, 1, 7, 7),
        "reduction_cell_1.conv_prev_1x1.conv.weight": (176, 528, 1, 1),
        "cell_12.path_2.conv.weight": (88, 528, 1, 1),
        "cell_15.comb_iter_4_left.bn_sep_2.running_mean": (176,)},
        ("cell_1.path_1.conv.weight", "cell_stem_0.comb_iter_1_left.weight",
         "cell_4.conv_1x1.conv.weight")),
}
SIZE = {"inceptionv4": (96, 80), "inceptionresnetv2": (96, 80)}


@pytest.mark.parametrize("name", list(PINS))
def test_reid_cadene_layout_matches_torchreid(name):
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
    assert {m.eps for m in net.modules()
            if isinstance(m, nn.BatchNorm2d)} == {BN_EPS[name]}


@pytest.mark.parametrize("name", [n for n in PINS if n != "nasnsetmobile"])
def test_reid_cadene_forward_matches_jax(name, tmp_path):
    size = SIZE.get(name, (64, 32))
    net = reid_net(name, seed=len(name), size=size)
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


def test_nasnet_alias_is_the_same_net():
    """The reference registry's typo ``nasnsetmobile`` builds
    ``nasnetamobile`` (both registries keep it)."""
    torch.manual_seed(3)
    a = build_reid_model("nasnetamobile").eval()
    torch.manual_seed(3)
    b = build_reid_model("nasnsetmobile").eval()
    x = torch.randn(1, 3, 64, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(a(x), b(x))
    assert JAX_FORWARDS["nasnsetmobile"] is JAX_FORWARDS["nasnetamobile"]
