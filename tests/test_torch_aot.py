"""``main.py pack`` and runtime/aot.py of the port on the CPU
(object_detection_tracking_tpu_torch; JAX main.py:420-503, aot.py).

A pack of the port's R18 forward at tests/torch_port_common.py's SMALL
sizes (f32, seeded weights through ``--load_from``) is loaded by
``load_packed``: its ``fn(params, images)`` equals the port's live forward
bit for bit and the JAX forward (``rpn_topk_recall=1.0``,
``roi_align_impl="xla"``, jitted) by ``compare_forward``'s rule. Its
``params.npz`` reads back through JAX's ``load_npz_tree`` as the packed
tree; a fresh process loads and runs the pack with JAX, the JAX package
and the port's ``models`` blocked. The CLI with JAX's own pack tests'
flags is in tests/test_torch_aot_cli.py; the CUDA graph replay is held
against the exported graph on the card (tests/test_torch_kernels_cuda.py).
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from object_detection_tracking_tpu.config import DetectorConfig as JaxConfig
from object_detection_tracking_tpu.utils.weights import load_npz_tree
from object_detection_tracking_tpu_torch import native
from object_detection_tracking_tpu_torch.cli import main as pack_cli
from object_detection_tracking_tpu_torch.params import save_npz_tree
from object_detection_tracking_tpu_torch.runtime import aot
from torch_port_common import (CONFIGS, H, W, compare_forward,  # noqa: F401
                               one_torch_thread, option_tree)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def images(b, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (b, h, w, 3),
                                               np.uint8)


def pack(tmp, name, *flags):
    pack_cli.main(["pack", "--outbasepath", str(tmp), "--modelname", name,
                 *flags])
    return os.path.join(str(tmp), name, "packed")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The SMALL R18 pack (B=2) of a seeded tree with detections, the tree
    and the JAX config of the same model."""
    tmp = tmp_path_factory.mktemp("aot")
    tree = option_tree(CONFIGS["r18"]())
    npz = os.path.join(str(tmp), "tree.npz")
    save_npz_tree(npz, tree)
    out = pack(tmp, "small", "--version", "2", "--num_class", "5",
               "--resnet18", "--short_edge_size", str(H), "--max_size",
               str(W), "--compute_dtype", "float32",
               "--rpn_test_post_nms_topk", "32", "--result_per_im", "8",
               "--im_batch_size", "2", "--load_from", npz, "--device", "cpu")
    cfg, params, fn = aot.load_packed(out, "cpu")
    jcfg = dataclasses.replace(
        JaxConfig(**dataclasses.asdict(cfg)), rpn_topk_recall=1.0,
        roi_align_impl="xla")
    return out, tree, jcfg, params, fn


def test_packed_forward_equals_live_and_jax(small):
    out, tree, jcfg, params, fn = small
    imgs = images(2, H, W)
    live, _ = compare_forward(jcfg, tree, imgs, jit=True)
    got = fn(params, torch.from_numpy(imgs))
    assert set(got) == set(live)
    for k in live:
        np.testing.assert_array_equal(got[k].numpy(), live[k], err_msg=k)
    with open(os.path.join(out, "config.json")) as f:
        meta = json.load(f)["pack"]
    assert meta["device"] == "cpu" and meta["kernels"] == []
    assert meta["torch"] == torch.__version__ and meta["batch"] == 2
    # each NMS and ROIAlign launch is one node of the graph, with no sync
    targets = [str(n.target) for n in fn.exported_program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("odt.greedy_keep.default") == 2
    assert targets.count("odt.multilevel_roi_align.default") == 2
    assert not [t for t in targets if "aten.equal" in t
                or "_local_scalar_dense" in t]
    assert os.listdir(os.path.join(out, "kernels")) == []


def test_params_npz_reads_back_through_jax(small):
    out, tree, _, params, _ = small
    back = load_npz_tree(os.path.join(out, "params.npz"))
    flat = pack_cli._flatten(tree)
    assert set(pack_cli._flatten(back)) == set(flat) == set(params)
    with open(os.path.join(out, "config.json")) as f:
        kinds = json.load(f)["pack"]["layout"]
    for name, leaf in pack_cli._flatten(back).items():
        np.testing.assert_array_equal(leaf, flat[name], err_msg=name)
        np.testing.assert_array_equal(
            aot.torch_layout(leaf, kinds.get(name, "plain")),
            params[name].numpy(), err_msg=name)
    # one host buffer per dtype, the leaves views into it
    storages = {t.untyped_storage().data_ptr() for t in params.values()}
    assert len(storages) == 1


def test_fresh_process_runs_the_pack_without_models(small, tmp_path):
    out, _, _, params, fn = small
    imgs = images(2, H, W, seed=1)
    ref = fn(params, torch.from_numpy(imgs))
    np.save(tmp_path / "imgs.npy", imgs)
    code = (
        "import sys\n"
        "for m in ('jax', 'object_detection_tracking_tpu',\n"
        "          'object_detection_tracking_tpu_torch.models'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from object_detection_tracking_tpu_torch.runtime.aot import "
        "load_packed\n"
        f"cfg, params, fn = load_packed({out!r}, 'cpu')\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'imgs.npy')!r}))\n"
        "got = fn(params, x)\n"
        f"np.savez({str(tmp_path / 'got.npz')!r},\n"
        "         **{k: v.numpy() for k, v in got.items()})\n"
        "assert 'object_detection_tracking_tpu_torch.models.faster_rcnn' "
        "not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(tmp_path), timeout=120)
    with np.load(tmp_path / "got.npz") as got:
        assert set(got.files) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k].numpy(), err_msg=k)


def test_load_packed_refuses_another_torch(small, tmp_path):
    with open(os.path.join(small[0], "config.json")) as f:
        raw = json.load(f)
    raw["pack"]["torch"] = "0.0.0"
    other = tmp_path / "packed"
    other.mkdir()
    with open(other / "config.json", "w") as f:
        json.dump(raw, f)
    with pytest.raises(RuntimeError, match="0.0.0.*"
                       + re.escape(torch.__version__)):
        aot.load_packed(str(other), "cpu")


def test_prebuilt_kernel_only_under_its_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "library_dirs", [])
    aot.enable_persistent_cache(str(tmp_path))
    assert native.library_dirs == [str(tmp_path)]
    assert native.prebuilt("nms") is None
    (tmp_path / "libnms-000000000000.so").write_bytes(b"stale")
    assert native.prebuilt("nms") is None
    src = os.path.join(native.PKG_DIR, native.CUDA_SOURCES["nms"])
    name = native.library_name(src, [native.cuda_tool("nvcc")]
                               + native.NVCC_FLAGS, "nms")
    (tmp_path / name).write_bytes(b"current")
    assert native.prebuilt("nms") == str(tmp_path / name)
