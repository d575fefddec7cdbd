"""The port's package boundary and its weights: it imports without jax, the
JAX param tree loads into its modules and back bit-exactly, and its JAX-free
init_params builds the JAX tree's structure and shapes."""

import os
import subprocess
import sys

import numpy as np
import pytest

import object_detection_tracking_tpu_torch as port
from object_detection_tracking_tpu.config import DetectorConfig
from object_detection_tracking_tpu_torch.models import get_model
from object_detection_tracking_tpu_torch.params import (init_params,
                                                        load_npz_tree,
                                                        params_from_jax,
                                                        params_to_jax)
from torch_port_common import one_torch_thread  # noqa: E402,F401

PKG = os.path.dirname(port.__file__)
ROOT = os.path.dirname(PKG)

TINY = dict(short_edge_size=64, max_size=96, compute_dtype="float32")
CFGS = {
    "r18": lambda: DetectorConfig(num_class=5, resnet_depth=18, **TINY),
    "r50_partial_coco": lambda: DetectorConfig.coco_partial(resnet_depth=50,
                                                            **TINY),
    "r50_v4": lambda: DetectorConfig.from_version(4, num_class=5,
                                                  resnet_depth=50, **TINY),
    "r50_se_resnext": lambda: DetectorConfig(num_class=5, resnet_depth=50,
                                             use_se=True, use_resnext=True,
                                             **TINY),
}


def flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flatten(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.parametrize("module", [
    "object_detection_tracking_tpu_torch",
    "object_detection_tracking_tpu_torch.cli.obj_detect_tracking",
])
def test_imports_without_jax(module):
    code = ("import sys; sys.modules['jax'] = None\n"
            f"import {module}\n"
            "import object_detection_tracking_tpu_torch.models.faster_rcnn\n"
            "import object_detection_tracking_tpu_torch.ops.roi_align\n"
            "assert not any(m == 'jax' or m.startswith('jax.') "
            "for m, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_file_of_the_package_imports_jax():
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "build"]   # generated output
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    for line in f:
                        s = line.strip()
                        assert not (s.startswith("import jax")
                                    or s.startswith("from jax")), (name, s)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_params_matches_jax_tree(name):
    jax = pytest.importorskip("jax")
    from object_detection_tracking_tpu.models import get_model as jax_model
    cfg = CFGS[name]()
    ref = dict(flatten(jax.eval_shape(jax_model(cfg).init_params,
                                      jax.random.PRNGKey(0))))
    got = dict(flatten(init_params(cfg, seed=0)))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        assert got[k].dtype == np.dtype(ref[k].dtype) == np.float32, k


@pytest.mark.parametrize("name", ["r18", "r50_se_resnext"])
def test_pytree_round_trip_is_bit_exact(name):
    """The r18 tree comes from JAX's init_params (jitted: eager, it
    compiles op by op for ~15 s); the SE-ResNeXt one from the port's (the
    same structure, test above), which is quicker."""
    cfg = CFGS[name]()
    if name == "r18":
        jax = pytest.importorskip("jax")
        from object_detection_tracking_tpu.models import get_model as jm
        tree = jax.tree.map(np.asarray, jax.jit(jm(cfg).init_params)(
            jax.random.PRNGKey(1)))
    else:
        tree = init_params(cfg, seed=1)
    back = dict(flatten(params_to_jax(params_from_jax(tree, get_model(cfg)))))
    ref = dict(flatten(tree))
    assert sorted(back) == sorted(ref)
    for k in ref:
        assert back[k].dtype == ref[k].dtype
        assert np.array_equal(back[k], ref[k]), k


def test_layouts_of_loaded_weights():
    cfg = CFGS["r18"]()
    tree = init_params(cfg, seed=3)
    m = params_from_jax(tree, get_model(cfg))
    w = tree["resnet"]["group1"]["block0"]["conv1"]["W"]        # HWIO
    assert np.array_equal(
        m.resnet.group1.block0.conv1.weight.numpy(), w.transpose(3, 2, 0, 1))
    fc6 = tree["fastrcnn"]["fc6"]["W"]                           # [in, out]
    assert np.array_equal(m.fastrcnn.fc6.weight.numpy(), fc6.T)
    bn = tree["resnet"]["conv0"]["bn"]
    assert np.array_equal(m.resnet.conv0.bn.variance.numpy(), bn["variance"])


def test_init_distributions():
    """Same initialiser families as JAX: truncated normal (+-2 std) with
    the variance-scaling std, or plain normal, per layer."""
    cfg = CFGS["r50_partial_coco"]()
    tree = init_params(cfg, seed=0)
    w = tree["fastrcnn"]["fc6"]["W"]                   # xavier1, fan_in 12544
    std = np.sqrt(1.0 / w.shape[0]) / .87962566103423978
    assert np.abs(w).max() <= 2 * std + 1e-7
    assert abs(w.std() / (0.87962566 * std) - 1) < 0.01
    w = tree["resnet"]["group2"]["block0"]["conv2"]["W"]    # msra, fan_in 9*256
    std = np.sqrt(2.0 / (9 * 256)) / .87962566103423978
    assert np.abs(w).max() <= 2 * std + 1e-7
    assert abs(w.std() / (0.87962566 * std) - 1) < 0.02
    w = tree["rpn"]["conv0"]["W"]                           # normal 0.01
    assert abs(w.std() / 0.01 - 1) < 0.02 and np.abs(w).max() > 0.03
    assert not tree["fpn"]["lateral_1x1_c2"]["b"].any()
    other = init_params(cfg, seed=1)
    assert not np.array_equal(other["fastrcnn"]["fc6"]["W"], w)


def test_load_npz_tree_reads_save_npz(tmp_path):
    cfg = CFGS["r18"]()
    tree = init_params(cfg, seed=0)
    flat = dict(flatten(tree))
    np.savez(tmp_path / "p.npz", **flat)
    back = dict(flatten(load_npz_tree(str(tmp_path / "p.npz"))))
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    np.savez(tmp_path / "tf.npz", **{"conv0/W:0": np.zeros(3)})
    with pytest.raises(ValueError, match="load_weights"):
        load_npz_tree(str(tmp_path / "tf.npz"))
