"""EfficientDet through the port's train loop (cli/main.py) on the CPU,
reached as the JAX package's quality proof reaches it (a config with
``model="efficientdet"``, cli/quality_proof.py:157-178): the JAX
convergence test's counterpart (tests/test_efficientdet.py:217-264) with
the BN calibration before the final checkpoint and ``final.npz``,
``run_eval`` on an EfficientDet, and the repairs this path needed
(``get_model("mask_rcnn")``, ``build_model`` by ``cfg.model``, gradients
when ``is_train``). efficientdet-test, float32."""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from object_detection_tracking_tpu.config import DetectorConfig
from object_detection_tracking_tpu_torch.cli import main as M
from object_detection_tracking_tpu_torch.models import get_model
from object_detection_tracking_tpu_torch.ops.norm import FrozenBN
from object_detection_tracking_tpu_torch.params import (load_npz_tree,
                                                        params_from_jax,
                                                        params_to_jax)
from torch_port_common import flat, port_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module: its small tensors gain
    nothing from more, and among the suite's parallel workers a process's
    many threads wait for each other at every op (the 25-step train below
    took 387 s beside three busy workers, 10 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RepeatBatch:
    """One batch yielded ``n`` times per epoch (DetectionTrainDataset's
    ``batches`` interface)."""

    def __init__(self, batch, n):
        self.batch = batch
        self.num_samples = n * batch[0].shape[0]

    def batches(self, epochs=1):
        for _ in range(self.num_samples // self.batch[0].shape[0] * epochs):
            yield self.batch


def effdet_config(args, image_size=128, name="efficientdet-test"):
    """The train flags' config turned into an EfficientDet one, as the JAX
    package's quality proof does (cli/quality_proof.py:157-178)."""
    cfg = M.build_config(args, True, torch.device("cpu"))
    return dataclasses.replace(cfg, model="efficientdet",
                               efficientdet_name=name,
                               efficientdet_image_size=image_size,
                               result_score_thres=0.05)


def test_train_converges_and_writes_calibrated_stats(tmp_path):
    """25 Adam steps on tests/test_efficientdet.py's two images through
    ``train``: the loss falls below half its start; the BN statistics are
    calibrated before the final checkpoint and final.npz, which hold them;
    an inference model loaded from final.npz fires on its training
    images."""
    imgs = np.zeros((2, 128, 128, 3), np.uint8)
    imgs[0, 20:60, 30:80] = 255
    imgs[1, 60:110, 10:50] = 180
    gtb = np.asarray([[[30, 20, 80, 60], [0, 0, 0, 0]],
                      [[10, 60, 50, 110], [0, 0, 0, 0]]], np.float32)
    gtl = np.asarray([[1, 0], [2, 0]], np.int32)
    gtv = np.asarray([[True, False], [True, False]])
    args = M.get_args([
        "train", "--device", "cpu", "--version", "2", "--num_class", "4",
        "--result_per_im", "8", "--optimizer", "adam", "--init_lr", "3e-3",
        "--lr_schedule", "constant", "--warmup_steps", "0", "--wd", "0",
        "--clip_gradient_norm", "10", "--num_step", "25", "--im_batch_size",
        "2", "--save_every", "1000", "--outbasepath", str(tmp_path)])
    cfg = effdet_config(args)
    model = M.build_model(args, cfg, torch.device("cpu"))
    assert type(model).__name__ == "EfficientDet"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = M.train(args, cfg, model, RepeatBatch((imgs, gtb, gtl, gtv),
                                                    25))
    totals = res["losses"]
    assert res["step"] == 25 and np.isfinite(totals).all()
    assert np.mean(totals[-3:]) < 0.5 * totals[0], totals
    n_bn = sum(isinstance(m, FrozenBN) for m in model.modules())
    assert f"calibrated {n_bn} BN sites over 16 batches" in out.getvalue()
    stats = {k: v for k, v in flat(params_to_jax(model)).items()
             if k.endswith(("/mean", "/variance"))}
    assert len(stats) == 2 * n_bn
    for k, v in stats.items():   # every site moved off the init's 0 / 1
        assert not np.all(v == (0.0 if k.endswith("mean") else 1.0)), k
    ckpt = torch.load(M.latest_ckpt(M.checkpoint_dir(args)))
    assert ckpt["step"] == 25
    for name, t in ckpt["params"].items():
        if name.endswith((".mean", ".variance")):
            np.testing.assert_array_equal(
                t.numpy(), stats[name.replace(".", "/")], err_msg=name)
    final = os.path.join(args.outbasepath, args.modelname, "final.npz")
    tree = load_npz_tree(final, "efficientdet")
    for k, v in stats.items():
        np.testing.assert_array_equal(flat(tree)[k], v, err_msg=k)
    infer = params_from_jax(tree, get_model(dataclasses.replace(
        cfg, is_train=False)))
    assert not any(p.requires_grad for p in infer.parameters())
    with torch.inference_mode():
        det = infer(torch.from_numpy(imgs))
    assert torch.isfinite(det["final_probs"]).all()
    assert det["final_valid"].any()


def test_run_eval_runs_an_efficientdet(tmp_path):
    """``run_eval`` builds its inference model from the config: an
    EfficientDet scores data/synthetic.py's images end to end."""
    from object_detection_tracking_tpu_torch.data.synthetic import \
        generate_dataset
    data = str(tmp_path / "val")
    lst = generate_dataset(data, 2, image_hw=(128, 128), seed=3)
    args = M.get_args([
        "train", "--device", "cpu", "--version", "2", "--num_class", "16",
        "--short_edge_size", "128", "--max_size", "128", "--vallst", lst,
        "--valframepath", os.path.join(data, "frames"), "--valannopath",
        os.path.join(data, "anno"), "--max_gt", "8"])
    cfg = effdet_config(args)
    model = M.build_model(args, cfg, torch.device("cpu"))
    cache = {}
    ap = M.run_eval(args, cfg, model, cache=cache)
    assert type(cache["model"]).__name__ == "EfficientDet"
    assert not cache["model"].config.is_train
    assert 0.0 <= ap <= 1.0


# --------------------------------------------------------------------------
# the repairs


def test_get_model_names_match_jax():
    """``mask_rcnn`` builds the Faster R-CNN class (it carries the mask
    head), as JAX's factory does; ``model`` in the config picks the
    class."""
    from object_detection_tracking_tpu.models import get_model as jax_model
    for name in ("faster_rcnn", "mask_rcnn", "efficientdet"):
        jcfg = DetectorConfig(num_class=4, resnet_depth=18,
                              efficientdet_name="efficientdet-test")
        assert type(get_model(port_config(jcfg), name)).__name__ == \
            type(jax_model(jcfg, name)).__name__
        cfg = port_config(dataclasses.replace(jcfg, model=name))
        assert type(get_model(cfg)).__name__ == \
            type(jax_model(dataclasses.replace(jcfg, model=name))).__name__


def test_build_initialises_and_loads_by_model(tmp_path):
    """``build_model`` draws the tree of ``cfg.model`` and reads
    ``--load_from`` with that model's roots, for EfficientDet and for
    ``mask_rcnn``."""
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            save_npz_tree)
    for model_name, extra in (("efficientdet", []),
                              ("mask_rcnn", ["--resnet18", "--add_mask"])):
        args = M.get_args(["train", "--device", "cpu", "--num_class", "4"]
                          + extra)
        cfg = effdet_config(args) if model_name == "efficientdet" else \
            dataclasses.replace(M.build_config(args, True,
                                               torch.device("cpu")),
                                model=model_name)
        tree = init_params(cfg, 7, model_name=model_name)
        path = str(tmp_path / f"{model_name}.npz")
        save_npz_tree(path, tree)
        args.load_from = path
        model = M.build_model(args, cfg, torch.device("cpu"))
        got = flat(params_to_jax(model))
        assert got.keys() == flat(tree).keys()
        for k, v in flat(tree).items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("is_train", [True, False])
def test_efficientdet_takes_gradients_only_when_training(is_train):
    jcfg = DetectorConfig(model="efficientdet",
                          efficientdet_name="efficientdet-test",
                          num_class=4, is_train=is_train)
    model = get_model(port_config(jcfg))
    assert all(p.requires_grad == is_train for p in model.parameters())
