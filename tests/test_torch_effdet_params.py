"""EfficientDet weights across the two packages: the port's JAX-free
``init_params`` gives JAX's tree (paths, shapes, dtypes, parameter count)
for d0 to d7; ``params_from_jax`` / ``params_to_jax`` round-trip bit for
bit, depthwise kernels (HWIO [k, k, 1, C] <-> [C, 1, k, k]) and the BiFPN
fusion vectors ``wsm`` included; the JAX package's native npz loads; and
the port's automl-name loader (utils/effdet_weights.py) gives what JAX's
``load_effdet_reference`` gives."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from object_detection_tracking_tpu.config import DetectorConfig  # noqa: E402
from object_detection_tracking_tpu.models.efficientdet import EfficientDet as JE  # noqa: E402
from object_detection_tracking_tpu.utils import effdet_weights as JW  # noqa: E402
from object_detection_tracking_tpu.utils.weights import save_npz  # noqa: E402
from object_detection_tracking_tpu_torch import params as TP  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.params import (  # noqa: E402
    init_params, load_npz_tree, params_from_jax, params_to_jax)
from object_detection_tracking_tpu_torch.utils import effdet_weights as TW  # noqa: E402
from object_detection_tracking_tpu_torch.utils.weights import load_weights  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import flat, port_config  # noqa: E402

# the published parameter counts in millions and the bounds of the JAX
# package's test_param_count_golden (tests/test_efficientdet.py:109-122)
GOLDEN = {0: (3.9, 0.15), 1: (6.6, 0.25), 5: (33.7, 1.0), 6: (51.9, 1.6),
          7: (51.9, 1.6)}


def cfg_of(name, partial=False):
    mk = DetectorConfig.coco_partial if partial else DetectorConfig.coco
    return mk(result_per_im=10, compute_dtype="float32",
              efficientdet_name=name, roi_align_impl="xla")


def no_draws(monkeypatch):
    """The port's init without its random draws (zeros of each shape):
    the tree's paths, shapes and dtypes are the same, and building d6's
    52 M values is not what a test of them needs."""
    def zeros(self, shape, *args):
        return np.zeros(shape, np.float32)
    monkeypatch.setattr(TP._Init, "_variance_scaling", zeros)
    monkeypatch.setattr(TP._Init, "_normal", zeros)


def random_tree(name, monkeypatch, seed=0):
    """The port's init tree for ``name`` with every leaf drawn anew from
    N(0, 1) (so that no two leaves of one shape are equal and a
    transposition shows)."""
    no_draws(monkeypatch)
    rng = np.random.default_rng(seed)
    tree = init_params(port_config(cfg_of(name)), seed, "efficientdet")

    def redraw(node):
        for k, v in node.items():
            if isinstance(v, dict):
                redraw(v)
            else:
                node[k] = rng.standard_normal(v.shape, np.float32)
    redraw(tree)
    return tree


@pytest.mark.parametrize("d", range(8))
def test_init_params_tree_matches_jax(d, monkeypatch):
    """Paths, shapes, dtypes and the parameter count for d0-d7 (the draws
    themselves checked at d0: their scale is the JAX initialiser's)."""
    name = f"efficientdet-d{d}"
    if d > 0:
        no_draws(monkeypatch)
    ref = jax.eval_shape(JE(cfg_of(name)).init_params,
                         jax.random.PRNGKey(0))
    ref = {"/".join(str(k.key) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = flat(init_params(port_config(cfg_of(name)), 0, "efficientdet"))
    assert sorted(got) == sorted(ref)
    for k, leaf in ref.items():
        assert got[k].shape == leaf.shape and got[k].dtype == leaf.dtype, k
    n = sum(v.size for v in got.values())
    assert n == sum(int(np.prod(v.shape)) for v in ref.values())
    if d in GOLDEN:
        millions, tol = GOLDEN[d]
        assert abs(n / 1e6 - millions) < tol, (name, n)
    assert got["class_net/predict/pw/b"][0] == np.float32(
        -np.log((1 - 0.01) / 0.01))
    if d == 0:
        # truncated normals of variance_scaling: xavier1 fan_in for the
        # class head's pointwise conv (1 x 1 x 64 inputs), msra fan_out
        # for the last block's projection (1 x 1 x 320 outputs)
        for k, std in (("class_net/predict/pw/W", np.sqrt(1.0 / 64)),
                       ("backbone/group6/block0/project/W",
                        np.sqrt(2.0 / 320))):
            assert abs(got[k].std() / std - 1) < 0.05, k
            assert np.abs(got[k]).max() <= 2 * std / .87962566103423978


@pytest.mark.parametrize("name", ["efficientdet-test", "efficientdet-d6"])
def test_params_round_trip_bit_exact(name, monkeypatch):
    tree = random_tree(name, monkeypatch)
    model = params_from_jax(tree, get_model(port_config(cfg_of(name)),
                                            "efficientdet"))
    back = params_to_jax(model)
    a, b = flat(tree), flat(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].dtype == np.float32 and np.array_equal(a[k], b[k]), k
    # a depthwise kernel HWIO [k, k, 1, C] is the conv weight [C, 1, k, k]
    w = tree["backbone"]["group1"]["block0"]["dw"]["W"]
    t = model.backbone.group1["block0"].dw.weight.detach().numpy()
    assert w.shape[2] == 1 and t.shape[1] == 1
    assert np.array_equal(t[:, 0], w[:, :, 0, :].transpose(2, 0, 1))
    if "wsm" in tree["fpn_cells"]["cell_0"]["fnode4"]:
        assert np.array_equal(
            model.fpn_cells["cell_0"]["fnode4"].wsm.detach().numpy(),
            tree["fpn_cells"]["cell_0"]["fnode4"]["wsm"])
        assert tree["fpn_cells"]["cell_0"]["fnode4"]["wsm"].shape == (3,)


def test_native_npz_loads_as_saved(tmp_path, monkeypatch):
    tree = random_tree("efficientdet-test", monkeypatch, 1)
    save_npz(str(tmp_path / "p.npz"), tree)
    got = flat(load_npz_tree(str(tmp_path / "p.npz"), "efficientdet"))
    ref = flat(tree)
    assert sorted(got) == sorted(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="load_weights"):
        load_npz_tree(str(tmp_path / "p.npz"))   # not a Faster R-CNN tree


def automl_dict(jm, tree, seed=0):
    """A synthetic automl checkpoint for JAX model ``jm``: every name of
    JAX's effdet_name_map with a random array in the checkpoint's layout
    (depthwise [H, W, C, 1], one scalar per WSM edge), plus leftovers the
    loader skips."""
    rng = np.random.RandomState(seed)
    leaves = flat(tree)
    out = {}
    for tf_name, (path, kind) in JW.effdet_name_map(jm).items():
        shape = leaves["/".join(path)].shape
        if kind == "dw":
            shape = shape[:2] + (shape[3], shape[2])
        elif isinstance(kind, tuple):
            shape = ()
        out[tf_name + ":0"] = np.asarray(rng.randn(*shape), np.float32)
    out["global_step:0"] = np.array(5)
    out["efficientnet-b0/head/dense/kernel:0"] = np.zeros((2, 2), np.float32)
    return out


@pytest.mark.parametrize("name", ["efficientdet-test", "efficientdet-d0"])
def test_automl_loader_matches_jax(name, tmp_path):
    cfg = cfg_of(name, partial=True)
    jm = JE(cfg)
    tree = init_params(port_config(cfg), 0, "efficientdet")
    weights = automl_dict(jm, tree)
    # JAX's loader starts from the model's init, which every mapped name
    # overwrites: give it the port's tree instead of a random draw
    jm.init_params = lambda key: tree
    ref = flat(JW.load_effdet_reference(dict(weights), jm))
    model = get_model(port_config(cfg), "efficientdet")
    got = flat(TW.load_effdet_reference(dict(weights), model))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    # --model_path with such an npz goes through it
    np.savez(str(tmp_path / "automl.npz"), **weights)
    assert TW.has_automl_names(np.load(str(tmp_path / "automl.npz")).files)
    via_cli = load_weights(str(tmp_path / "automl.npz"), model)
    assert all(np.array_equal(flat(via_cli)[k], ref[k]) for k in ref)
    params_from_jax(via_cli, model)
    assert torch.equal(model.class_net.predict.pw.bias,
                       torch.from_numpy(ref["class_net/predict/pw/b"]))


def test_tf_checkpoint_route_raises_naming_a12(tmp_path):
    """The TF-checkpoint route (ported with A12): a path that is no
    checkpoint raises JAX's ValueError; a bundle of automl names there
    loads as its npz does."""
    from tests.test_tf_ckpt import write_bundle
    cfg = cfg_of("efficientdet-test")
    model = get_model(port_config(cfg), "efficientdet")
    path = str(tmp_path / "model.ckpt")
    with pytest.raises(ValueError, match="unsupported checkpoint format"):
        load_weights(path, model)
    weights = automl_dict(JE(cfg), init_params(port_config(cfg), 0,
                                               "efficientdet"))
    write_bundle(path, {k[:-2]: np.asarray(v) for k, v in weights.items()})
    got, want = flat(load_weights(path, model)), flat(
        TW.load_effdet_reference(dict(weights), model))
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
