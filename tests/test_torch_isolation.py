"""The port stands alone: it imports, builds the CLI's configuration,
solves an assignment and runs a training forward and backward with both
``jax`` and the JAX package blocked, no source of it (nor chip_smoke.py)
imports the JAX package or reads one of its files, and its own copies of
the JAX-free modules (config, class_ids, utils/masks, csrc/lapjv.cpp,
data/training.py, data/synthetic.py, evaluation.py, evaluation_mot.py,
tracking/tmot/, reid/, data/datasets.py, the automl name map of
utils/effdet_weights.py, utils/tf_ckpt.py, data/coco.py, data/kf1.py, the
tooling CLIs)
hold the same values as the originals; and the checkpoint load of
``--model_path`` and ``--load_from`` is JAX's strict one."""

import ast
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import object_detection_tracking_tpu_torch as port
from object_detection_tracking_tpu import class_ids as jids
from object_detection_tracking_tpu import config as jconfig
from object_detection_tracking_tpu_torch import class_ids as tids
from object_detection_tracking_tpu_torch import config as tconfig
from torch_port_common import one_torch_thread  # noqa: F401

PKG = os.path.dirname(port.__file__)
ROOT = os.path.dirname(PKG)
JAX_PKG = "object_detection_tracking_tpu"
# a name of the JAX package (not of the port): "object_detection_tracking_tpu"
# followed by anything but "_torch"
_NAMES_JAX_PKG = re.compile(JAX_PKG + r"(?!_torch)\b")
# a reference citation such as "object_detection_tracking_tpu/ops/x.py:138"
_CITATION = re.compile(JAX_PKG + r"/[\w/]+\.py:\d+")


def _sources():
    for dirpath, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        for name in sorted(files):
            if name.endswith((".py", ".cu", ".cpp", ".h", ".cuh")):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "tools", "torch_roi_align_ab.py")
    yield os.path.join(ROOT, "tools", "torch_effdet_f32_noise.py")
    yield os.path.join(ROOT, "tools", "torch_dp_step_ab.py")
    yield os.path.join(ROOT, "tools", "torch_runner_fanout.py")
    yield os.path.join(ROOT, "tools", "torch_dp_cards.py")
    yield os.path.join(ROOT, "tools", "torch_pack_coldstart.py")
    yield os.path.join(ROOT, "tools", "torch_nms_ab.py")


def test_port_runs_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.modules['{JAX_PKG}'] = None\n"
        "import numpy as np, torch\n"
        "import chip_smoke\n"
        "from object_detection_tracking_tpu_torch.cli import "
        "obj_detect_tracking as cli\n"
        "from object_detection_tracking_tpu_torch.tracking import assignment\n"
        "args = cli.get_args(['--video_dir', '.', '--video_lst_file', 'x', "
        "'--add_mask'])\n"
        "cfg = cli.build_config(args, torch.device('cpu'))\n"
        "assert cfg.resnet_depth == 101 and cfg.add_mask, cfg\n"
        "args = cli.get_args(['--video_dir', '.', '--video_lst_file', 'x', "
        "'--is_efficientdet', '--efficientdet_modelname', "
        "'efficientdet-test', '--use_partial_classes'])\n"
        "cfg = cli.build_config(args, torch.device('cpu'))\n"
        "from object_detection_tracking_tpu_torch.models import get_model\n"
        "from object_detection_tracking_tpu_torch.params import "
        "init_params, params_from_jax\n"
        "from object_detection_tracking_tpu_torch.utils import "
        "effdet_weights\n"
        "m = params_from_jax(init_params(cfg, 0, 'efficientdet'), "
        "get_model(cfg, 'efficientdet'))\n"
        "out = m(torch.zeros(1, 72, 128, 3, dtype=torch.uint8))\n"
        "assert out['pooled_box_feat'].shape == (1, 100, 32), out\n"
        "assert effdet_weights.effdet_name_map(m)\n"
        "rows, cols = assignment.linear_sum_assignment(\n"
        "    np.array([[4., 1., 3.], [2., 0., 5.], [3., 2., 2.]]))\n"
        "assert sorted(zip(rows.tolist(), cols.tolist())) == "
        "[(0, 1), (1, 0), (2, 2)]\n"
        "assert assignment._load_native() is not None\n"
        "from object_detection_tracking_tpu_torch.cli import "
        "track_quality_proof\n"
        "from object_detection_tracking_tpu_torch.tracking.tmot import "
        "JDETracker\n"
        "x, y = assignment.lapjv_extended(np.array([[0.1, 0.9], [0.2, "
        "np.inf], [0.95, 0.3]]), cost_limit=0.5)\n"
        "assert x.tolist() == [0, -1, 1] and y.tolist() == [0, 2], (x, y)\n"
        "t = JDETracker(0.5)\n"
        "for _ in range(2):\n"
        "    out = t.update([((1., 2., 30., 40.), 0.9, np.ones(8))])\n"
        "assert [s.track_id for s in out] == [1], out\n"
        "from object_detection_tracking_tpu_torch.cli import "
        "multi_video_reid, obj_detect_imgs, reid_query, single_video_reid\n"
        "from object_detection_tracking_tpu_torch.config import "
        "DetectorConfig\n"
        "cfg = DetectorConfig(num_class=4, resnet_depth=50, "
        "short_edge_size=32, max_size=64, rpn_test_post_nms_topk=16, "
        "compute_dtype='float32', use_gn=True, use_deformable=True, "
        "add_relation_nn=True, use_att_frcnn_head=True, "
        "fpn_frcnn_fc_head_dim=64)\n"
        "m = params_from_jax(init_params(cfg), get_model(cfg))\n"
        "img = torch.zeros(1, 32, 64, 3, dtype=torch.uint8)\n"
        "f = m.extract_box_feat(img, torch.tensor([[[2., 3., 20., 30.]]]))\n"
        "assert f.shape == (1, 1, 256) and torch.isfinite(f).all(), f\n"
        "assert torch.isfinite(m(img)['final_probs']).all()\n"
        "from object_detection_tracking_tpu_torch.models.reid.extractor "
        "import FeatureExtractor, build_reid_model\n"
        "import tempfile, os\n"
        "p = os.path.join(tempfile.mkdtemp(), 'o.pth')\n"
        "torch.save(build_reid_model('osnet_x0_25').state_dict(), p)\n"
        "ex = FeatureExtractor('osnet_x0_25', p, image_size=(64, 32), "
        "compute_dtype='float32', device='cpu')\n"
        "f = ex([np.zeros((40, 20, 3), np.uint8)])\n"
        "assert f.shape == (1, 512) and np.isfinite(f).all(), f\n"
        "for name in ('se_resnet50', 'squeezenet1_1', 'shufflenet', "
        "'nasnetamobile'):\n"
        "    build_reid_model(name)\n"
        "cfg = DetectorConfig(num_class=16, resnet_depth=18, "
        "short_edge_size=32, max_size=64, rpn_test_post_nms_topk=16, "
        "result_per_im=4, so_person_topk=2, compute_dtype='float32', "
        "fpn_frcnn_fc_head_dim=64, use_small_object_head=True, "
        "use_so_association=True)\n"
        "m = params_from_jax(init_params(cfg), get_model(cfg))\n"
        "assert torch.isfinite(m(img)['so_final_probs']).all()\n"
        "from object_detection_tracking_tpu_torch.utils import tf_ckpt, "
        "weights\n"
        "from object_detection_tracking_tpu_torch.data import coco, kf1, "
        "video\n"
        "from object_detection_tracking_tpu_torch.runtime import profiler\n"
        "from object_detection_tracking_tpu_torch.runtime import aot\n"
        "from object_detection_tracking_tpu_torch.cli import (eval, "
        "eval_mot, track_to_json, vis_json, vis_tracks, get_frames_resize, "
        "check_and_vis_global_tracks, kf1_convert, generate_util_graph)\n"
        "d = tempfile.mkdtemp()\n"
        "np.savez(os.path.join(d, 'tf.npz'), **{'conv0/W:0': "
        "np.ones((7, 7, 3, 64), np.float32), 'global_step:0': np.array(3)})"
        "\n"
        "t = weights.load_weights(os.path.join(d, 'tf.npz'), m)\n"
        "assert (t['resnet']['conv0']['W'] == 1).all()\n"
        "p = profiler.PerformanceLogger(0.01, 'cpu')\n"
        "p._sample()\n"
        "assert p.summary()['device_bytes_max'] == 0.0\n"
        "assert not video._HAS_AV or 'av' in sys.modules\n"
        f"bad = [m for m, v in sys.modules.items() if v is not None and "
        f"(m == 'jax' or m.startswith('jax.') or m == '{JAX_PKG}' or "
        f"m.startswith('{JAX_PKG}.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_source_imports_or_reads_the_jax_package():
    """Imports (Python ASTs, C #includes) and string constants other than
    docstrings and file:line citations must not name the JAX package."""
    scanned = set()
    for path in _sources():
        with open(path) as f:
            text = f.read()
        rel = os.path.relpath(path, ROOT)
        scanned.add(rel)
        if not path.endswith(".py"):
            for line in text.splitlines():
                if line.lstrip().startswith("#include"):
                    assert not _NAMES_JAX_PKG.search(line), (rel, line)
            continue
        tree = ast.parse(text)
        docstrings = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)) and node.body:
                first = node.body[0]
                if isinstance(first, ast.Expr) and isinstance(
                        first.value, ast.Constant):
                    docstrings.add(id(first.value))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str)
                  and id(node) not in docstrings):
                rest = _CITATION.sub("", node.value)
                assert not _NAMES_JAX_PKG.search(rest), (rel, node.lineno)
                continue
            else:
                continue
            for name in names:
                assert not _NAMES_JAX_PKG.match(name), (rel, node.lineno)
                assert name != "jax" and not name.startswith("jax."), (
                    rel, node.lineno)
    assert {"chip_smoke.py",
            "object_detection_tracking_tpu_torch/cli/track_quality_proof.py",
            "object_detection_tracking_tpu_torch/tracking/tmot/"
            "multitracker.py",
            "object_detection_tracking_tpu_torch/cli/single_video_reid.py",
            "object_detection_tracking_tpu_torch/cli/multi_video_reid.py",
            "object_detection_tracking_tpu_torch/cli/reid_query.py",
            "object_detection_tracking_tpu_torch/models/reid/common.py",
            "object_detection_tracking_tpu_torch/models/reid/osnet.py",
            "object_detection_tracking_tpu_torch/models/reid/resnet_reid.py",
            "object_detection_tracking_tpu_torch/models/reid/extractor.py",
            "object_detection_tracking_tpu_torch/reid/multi_video.py",
            "object_detection_tracking_tpu_torch/cli/obj_detect_imgs.py",
            "object_detection_tracking_tpu_torch/data/datasets.py",
            "object_detection_tracking_tpu_torch/models/deformable.py",
            "object_detection_tracking_tpu_torch/models/relation.py",
            "object_detection_tracking_tpu_torch/utils/weights.py",
            "object_detection_tracking_tpu_torch/utils/tf_ckpt.py",
            "object_detection_tracking_tpu_torch/runtime/profiler.py",
            "object_detection_tracking_tpu_torch/data/video.py",
            "object_detection_tracking_tpu_torch/data/coco.py",
            "object_detection_tracking_tpu_torch/data/kf1.py",
            *(f"object_detection_tracking_tpu_torch/cli/{m}.py"
              for m in COPIED_CLIS + USAGE_CLIS),
            *(f"object_detection_tracking_tpu_torch/models/reid/{m}.py"
              for m in ("senet_reid", "ibn_reid", "mobilenetv2",
                        "densenet_reid", "squeezenet_reid",
                        "shufflenet_reid", "shufflenetv1_reid", "pcb_reid",
                        "resnetmid_reid", "mlfn_reid", "hacnn_reid",
                        "mudeep_reid", "xception_reid", "inceptionv4_reid",
                        "inceptionresnetv2_reid", "nasnet_reid")),
            "object_detection_tracking_tpu_torch/parallel/__init__.py",
            "object_detection_tracking_tpu_torch/parallel/mesh.py",
            "object_detection_tracking_tpu_torch/runtime/aot.py",
            "object_detection_tracking_tpu_torch/csrc/nms.cu",
            "tools/torch_pack_coldstart.py",
            "tools/torch_nms_ab.py",
            } <= scanned


def test_training_runs_with_jax_and_the_jax_package_blocked():
    """The train CLI imports, and small CPU forward_train and backward
    passes of Faster R-CNN (with masks) and EfficientDet run, an
    EfficientDet's BN statistics calibrate, and a one-rank gloo
    data-parallel step runs (parallel/mesh.py), with nothing of JAX
    importable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.modules['{JAX_PKG}'] = None\n"
        "import numpy as np, torch\n"
        "from object_detection_tracking_tpu_torch.cli import main\n"
        "from object_detection_tracking_tpu_torch.config import "
        "DetectorConfig\n"
        "from object_detection_tracking_tpu_torch.models import get_model\n"
        "from object_detection_tracking_tpu_torch.params import "
        "init_params, params_from_jax\n"
        "args = main.get_args(['train', '--device', 'cpu', '--add_mask'])\n"
        "cfg = DetectorConfig(num_class=4, resnet_depth=18, "
        "short_edge_size=48, max_size=64, rpn_train_post_nms_topk=32, "
        "rpn_batch_per_im=32, fastrcnn_batch_per_im=16, "
        "compute_dtype='float32', is_train=True, add_mask=True, "
        "roi_align_train_impl='pallas')\n"
        "m = params_from_jax(init_params(cfg), get_model(cfg))\n"
        "rng = np.random.RandomState(0)\n"
        "img = torch.from_numpy(rng.randint(0, 255, (2, 48, 64, 3))"
        ".astype(np.uint8))\n"
        "gt = torch.tensor([[[4., 5., 20., 30.]]] * 2)\n"
        "losses = m.forward_train(img, gt, torch.ones(2, 1, dtype=torch.int32),"
        " torch.ones(2, 1, dtype=torch.bool), "
        "gt_masks=torch.ones(2, 1, 28, 28), "
        "generator=torch.Generator().manual_seed(0))\n"
        "losses['total_loss'].backward()\n"
        "assert torch.isfinite(losses['total_loss']), losses\n"
        "assert m.maskrcnn.fcn0.weight.grad.abs().sum() > 0\n"
        "cfg = DetectorConfig(model='efficientdet', efficientdet_name="
        "'efficientdet-test', num_class=4, compute_dtype='float32', "
        "is_train=True)\n"
        "e = params_from_jax(init_params(cfg, 0, 'efficientdet'), "
        "get_model(cfg))\n"
        "img = torch.from_numpy(rng.randint(0, 255, (2, 128, 128, 3))"
        ".astype(np.uint8))\n"
        "losses = e.forward_train(img, gt, torch.ones(2, 1, dtype=torch.int32),"
        " torch.ones(2, 1, dtype=torch.bool))\n"
        "losses['total_loss'].backward()\n"
        "assert torch.isfinite(losses['total_loss']), losses\n"
        "assert e.class_net.predict.pw.weight.grad.abs().sum() > 0\n"
        "e.calibrate_bn([img.numpy()])\n"
        "assert not torch.all(e.backbone.stem.bn.variance == 1)\n"
        "import os, socket\n"
        "from object_detection_tracking_tpu_torch.config import "
        "TrainConfig\n"
        "from object_detection_tracking_tpu_torch.parallel import mesh\n"
        "s = socket.socket(); s.bind(('127.0.0.1', 0))\n"
        "os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT="
        "str(s.getsockname()[1]), RANK='0', WORLD_SIZE='1')\n"
        "s.close()\n"
        "assert mesh.launched_by_torchrun()\n"
        "mesh.init_distributed('cpu', timeout_s=60)\n"
        "_, step = mesh.make_sharded_train_step(m, TrainConfig(), "
        "mesh.make_mesh(timeout_s=60))\n"
        "img = torch.from_numpy(rng.randint(0, 255, (2, 48, 64, 3))"
        ".astype(np.uint8))\n"
        "losses = step(img, gt, torch.ones(2, 1, dtype=torch.int32), "
        "torch.ones(2, 1, dtype=torch.bool), torch.ones(2, 1, 28, 28), "
        "generator=torch.Generator().manual_seed(0))\n"
        "assert torch.isfinite(losses['total_loss']), losses\n"
        "torch.distributed.destroy_process_group()\n"
        f"bad = [k for k, v in sys.modules.items() if v is not None and "
        f"(k == 'jax' or k.startswith('jax.') or k == '{JAX_PKG}' or "
        f"k.startswith('{JAX_PKG}.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_trainer_decays_the_leaves_of_the_jax_rule_on_efficientdet():
    """The Trainer's decay set on the EfficientDet tree is JAX's mask
    (train/trainer.py:59-63: every leaf with a "W" key in its path), and
    every trainable parameter is a leaf of the tree (fusion weights and
    BN statistics included)."""
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import (_leaves,
                                                            params_to_jax)
    from object_detection_tracking_tpu_torch.train import Trainer
    cfg = tconfig.DetectorConfig(model="efficientdet",
                                 efficientdet_name="efficientdet-test",
                                 num_class=4, is_train=True)
    model = get_model(cfg)
    trainer = Trainer(model, tconfig.TrainConfig(wd=1e-4))

    def paths(node, prefix=()):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from paths(v, prefix + (k,))
            else:
                yield prefix + (k,)
    tree_paths = list(paths(params_to_jax(model)))
    want = {"/".join(p) for p in tree_paths if "W" in p}
    assert trainer.opt.decay == want
    assert set(trainer.opt.params) == {"/".join(p) for p in tree_paths}
    assert len(want) > 100 and any(p[-1] == "wsm" for p in tree_paths)
    groups = trainer.opt.torch_opt.param_groups
    assert sum(len(g["params"]) for g in groups) == len(list(_leaves(model)))
    assert [g["weight_decay"] for g in groups] == [1e-4, 0.0]
    assert {id(p) for p in groups[0]["params"]} == {
        id(trainer.opt.params[n]) for n in want}


def _properties(cls):
    return sorted(n for n, v in vars(cls).items() if isinstance(v, property))


PRESETS = [("version", v) for v in (2, 3, 4, 5, 6)] + [("coco", None),
                                                        ("coco_partial", None),
                                                        ("default", None)]


def _preset(mod, kind, arg):
    cls = mod.DetectorConfig
    if kind == "version":
        return cls.from_version(arg)
    if kind == "default":
        return cls()
    return getattr(cls, kind)()


@pytest.mark.parametrize("kind,arg", PRESETS)
def test_config_presets_equal_jax(kind, arg):
    ref, got = _preset(jconfig, kind, arg), _preset(tconfig, kind, arg)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.classname2id == ref.classname2id
    names = _properties(jconfig.DetectorConfig)
    assert names == _properties(tconfig.DetectorConfig)
    for name in names:
        assert getattr(got, name) == getattr(ref, name), name


def test_tracker_config_and_resnet_arch_equal_jax():
    assert dataclasses.asdict(tconfig.TrackerConfig()) == \
        dataclasses.asdict(jconfig.TrackerConfig())
    assert dataclasses.asdict(tconfig.TrainConfig()) == \
        dataclasses.asdict(jconfig.TrainConfig())
    assert [f.name for f in dataclasses.fields(tconfig.TrainConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.TrainConfig)]
    assert tconfig.RESNET_ARCH == jconfig.RESNET_ARCH
    assert [f.name for f in dataclasses.fields(tconfig.DetectorConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.DetectorConfig)]


def test_class_id_tables_equal_jax():
    public = sorted(n for n in vars(jids) if not n.startswith("_")
                    and isinstance(getattr(jids, n), (dict, list, tuple)))
    assert public
    for name in public:
        assert getattr(tids, name) == getattr(jids, name), name


def test_lapjv_source_is_the_jax_solver():
    """Same code as the JAX package's native/lapjv.cpp; comments may
    differ."""
    def code(path):
        with open(path) as f:
            text = re.sub(r"//[^\n]*", "", f.read())
        return [ln.strip() for ln in text.splitlines() if ln.strip()]
    assert code(os.path.join(PKG, "csrc", "lapjv.cpp")) == code(
        os.path.join(ROOT, JAX_PKG, "native", "lapjv.cpp"))


# the tooling CLIs: copies of the JAX package's files, byte for byte, or
# (USAGE_CLIS) but for their docstrings' ``python -m`` usage lines
COPIED_CLIS = ("eval", "track_to_json", "get_frames_resize",
               "check_and_vis_global_tracks", "kf1_convert",
               "generate_util_graph")
USAGE_CLIS = ("eval_mot", "vis_json", "vis_tracks")


@pytest.mark.parametrize("path", ["data/training.py", "data/synthetic.py",
                                  "data/datasets.py", "data/coco.py",
                                  "data/kf1.py", "utils/tf_ckpt.py",
                                  *(f"cli/{m}.py" for m in COPIED_CLIS),
                                  "evaluation.py", "evaluation_mot.py",
                                  "tracking/tmot/__init__.py",
                                  "tracking/tmot/matching.py",
                                  "tracking/tmot/multitracker.py",
                                  "reid/__init__.py", "reid/cameras.py",
                                  "reid/single_video.py",
                                  "reid/multi_video.py"])
def test_jax_free_module_copies_equal_the_originals(path):
    """The port's copies of the JAX package's numpy/cv2 modules are the
    same source, byte for byte (their relative imports resolve to the
    port's own ops/boxes.py, whose get_new_hw and pairwise_iou_np are the
    JAX module's host code, unchanged)."""
    with open(os.path.join(PKG, path), "rb") as f:
        got = f.read()
    with open(os.path.join(ROOT, JAX_PKG, path), "rb") as f:
        assert got == f.read()


@pytest.mark.parametrize("name", USAGE_CLIS)
def test_tooling_cli_copies_differ_only_in_usage_lines(name):
    """These CLIs name their package in their usage lines: with the JAX
    package's name in those lines, the port's copy is the original."""
    with open(os.path.join(PKG, "cli", f"{name}.py")) as f:
        got = f.read()
    with open(os.path.join(ROOT, JAX_PKG, "cli", f"{name}.py")) as f:
        ref = f.read()
    assert got != ref
    assert got.replace(f"python -m {JAX_PKG}_torch.cli.",
                       f"python -m {JAX_PKG}.cli.") == ref


def _strict_load_setup(tmp_path, tag):
    """A tiny R18 configuration's seeded tree written as a native npz with
    one leaf left out (``partial``) or one name added (``extra``)."""
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            save_npz_tree)
    cfg = tconfig.DetectorConfig(num_class=4, resnet_depth=18,
                                 short_edge_size=32, max_size=64,
                                 fpn_frcnn_fc_head_dim=64,
                                 compute_dtype="float32")
    tree = init_params(cfg, seed=5)
    if tag == "partial":
        del tree["fastrcnn"]["fc7"]["W"]
    else:
        tree["fastrcnn"]["bogus"] = {"W": np.zeros((2, 2), np.float32)}
    path = str(tmp_path / f"{tag}.npz")
    save_npz_tree(path, tree)
    return cfg, tree, path


@pytest.mark.parametrize("entry", ["model_path", "load_from"])
def test_native_npz_load_is_strict_as_in_jax(tmp_path, entry):
    """The native npz through --model_path (cli/obj_detect_tracking.py
    load_model) and --load_from (cli/main.py build_model), as JAX's
    load_weights reads it (utils/weights.py:160-168): a partial npz loads,
    the leaf it lacks keeping the seeded init; a name the model lacks
    raises KeyError."""
    import torch
    from object_detection_tracking_tpu_torch.cli import main as tmain
    from object_detection_tracking_tpu_torch.cli import \
        obj_detect_tracking as tcli
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            params_to_jax)
    cpu = torch.device("cpu")

    def load(cfg, path):
        if entry == "model_path":
            args = tcli.get_args(["--video_dir", ".", "--video_lst_file",
                                  "x", "--model_path", path])
            return tcli.load_model(args, cfg, cpu)
        args = tmain.get_args(["train", "--load_from", path])
        return tmain.build_model(args, cfg, cpu)

    cfg, tree, path = _strict_load_setup(tmp_path, "partial")
    got = params_to_jax(load(cfg, path))
    np.testing.assert_array_equal(got["fastrcnn"]["fc6"]["W"],
                                  tree["fastrcnn"]["fc6"]["W"])
    np.testing.assert_array_equal(got["fastrcnn"]["fc7"]["W"],
                                  init_params(cfg, seed=0)["fastrcnn"]["fc7"]
                                  ["W"])
    cfg, _, path = _strict_load_setup(tmp_path, "extra")
    with pytest.raises(KeyError, match="fastrcnn/bogus/W"):
        load(cfg, path)


def test_masks_match_jax():
    pytest.importorskip("cv2")
    from object_detection_tracking_tpu.utils import masks as jm
    from object_detection_tracking_tpu_torch.utils import masks as tm
    rng = np.random.RandomState(0)
    im_hw = (72, 96)
    for _ in range(20):
        soft = rng.rand(28, 28).astype(np.float32)
        x0, y0 = rng.rand(2) * (im_hw[1] - 10, im_hw[0] - 10)
        box = np.array([x0, y0, x0 + 1 + rng.rand() * 60,
                        y0 + 1 + rng.rand() * 50], np.float32)
        ref = jm.fill_full_mask(box, soft, im_hw)
        got = tm.fill_full_mask(box, soft, im_hw)
        np.testing.assert_array_equal(got, ref)
        rle = tm.rle_encode(got)
        assert rle == jm.rle_encode(ref)
        np.testing.assert_array_equal(tm.rle_decode(rle), ref)
        np.testing.assert_array_equal(jm.rle_decode(rle), got)


@pytest.mark.parametrize("name", ["efficientdet-test", "efficientdet-d0",
                                  "efficientdet-d6"])
def test_effdet_name_map_equals_the_original(name):
    """The port's copy of utils/effdet_weights.py maps every automl name
    to the same tree path and kind as the JAX module."""
    from object_detection_tracking_tpu.config import DetectorConfig
    from object_detection_tracking_tpu.models.efficientdet import \
        EfficientDet as JE
    from object_detection_tracking_tpu.utils import effdet_weights as jw
    from object_detection_tracking_tpu_torch.models.efficientdet import \
        EfficientDet as TE
    from object_detection_tracking_tpu_torch.utils import \
        effdet_weights as tw
    jcfg = DetectorConfig.coco(efficientdet_name=name)
    tcfg = tconfig.DetectorConfig.coco(efficientdet_name=name)
    assert tw.effdet_name_map(TE(tcfg)) == jw.effdet_name_map(JE(jcfg))
    assert tw._BN == jw._BN
