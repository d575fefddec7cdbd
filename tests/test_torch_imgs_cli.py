"""The port's image-list CLI and its data plane against the JAX package on
the CPU: ``ImageDataset`` and ``DatasetEnqueuer`` (one worker, worker
threads, spawned worker processes) on PNGs written with cv2, the whole
``obj_detect_imgs`` CLI on five PNGs of mixed sizes (R18 through
--model_path, --im_batch_size 2; EfficientDet; --person_only), and
``extract_box_feat`` on the caller's boxes.

Both CLIs read one ``.npz`` (the port's init with each residual branch's
last BN gamma x0.2, torch_port_common.option_tree, and +1 on the Person
logit so that --person_only keeps detections; EfficientDet's calibrated as
torch_port_common.effdet_params says), in float32. The JAX CLI runs its
own main with ``roi_align_impl="xla"`` (the exact reference) and an exact
top-k, its XLA cache under this test's temp dir, and its runner's
temporal-delta transfer off (``_jax_main``). The JSON files must
agree: the same file set; at least 0.98 of JAX's detections matched by
label with each bbox number within 0.02 (two decimals in the files: a
box 1e-4 px off can round the other way) and the score within 1e-5.
"""

import dataclasses
import json
import os
from functools import partial

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
import torch  # noqa: E402

from object_detection_tracking_tpu.cli import obj_detect_imgs as jcli  # noqa: E402
from object_detection_tracking_tpu.data import DatasetEnqueuer as JEnq  # noqa: E402
from object_detection_tracking_tpu.data import ImageDataset as JDataset  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu.runtime import DetectionRunner as JRunner  # noqa: E402
from object_detection_tracking_tpu.utils import weights as jweights  # noqa: E402
from object_detection_tracking_tpu_torch.cli import obj_detect_imgs as tcli  # noqa: E402
from object_detection_tracking_tpu_torch.data import DatasetEnqueuer  # noqa: E402
from object_detection_tracking_tpu_torch.data import ImageDataset  # noqa: E402
from object_detection_tracking_tpu_torch.models import get_model  # noqa: E402
from object_detection_tracking_tpu_torch.params import (params_from_jax,  # noqa: E402
                                                        save_npz_tree)
from torch_port_common import (CONFIGS, H, W, close, effdet_params,  # noqa: E402
                               option_tree, port_config)

# (h, w) of the five images; the CLI fits each to short edge 64, max 128:
# 64x128, 64x100 | 64x115, 64x128 | 64x64, so that the two full batches
# share one padded shape (each shape is one more JAX compile)
SIZES = [(96, 192), (64, 100), (50, 90), (32, 64), (70, 70)]
ARGV = ["--resnet18", "--short_edge_size", "64", "--max_size", "128",
        "--im_batch_size", "2", "--compute_dtype", "float32",
        "--rpn_test_post_nms_topk", "32", "--threshold_conf", "0.05"]
EFFDET = ["--is_efficientdet", "--efficientdet_modelname",
          "efficientdet-test", "--short_edge_size", "128", "--max_size",
          "128", "--im_batch_size", "2", "--compute_dtype", "float32",
          "--threshold_conf", "0.05"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module, as
    tests/test_torch_effdet_train.py pins it: alone the module takes as
    long with one as with eight, and among the suite's parallel workers a
    process's many threads wait for each other at every op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_pngs(root, sizes=SIZES, seed=0):
    rng = np.random.RandomState(seed)
    paths = []
    for i, (h, w) in enumerate(sizes):
        im = np.tile(np.linspace(30, 200, w, dtype=np.uint8), (h, 1))
        im = np.stack([im, im[::-1], np.full_like(im, 90)], axis=-1)
        for _ in range(3):
            x0, y0 = rng.randint(0, w // 2), rng.randint(0, h // 2)
            cv2.rectangle(im, (x0, y0), (x0 + w // 3, y0 + h // 3),
                          tuple(int(c) for c in rng.randint(0, 255, 3)), -1)
        im = np.clip(im + rng.randint(-8, 8, im.shape), 0, 255
                     ).astype(np.uint8)
        path = os.path.join(root, f"im{i}.png")
        cv2.imwrite(path, im)
        paths.append(path)
    return paths


# --------------------------------------------------------------------------
# ImageDataset and DatasetEnqueuer


@pytest.mark.parametrize("workers,use_process", [(1, False), (2, False),
                                                 (2, True)])
def test_dataset_enqueuer_batches_equal_jax(tmp_path, workers, use_process):
    """The same batches as JAX's (resized pixels, padding to the batch's
    largest extent, names, paths, scales, original sizes), in order."""
    paths = write_pngs(str(tmp_path))

    def batches(dataset_cls, enq_cls):
        ds = dataset_cls(paths, 64, 128, batch_size=2)
        return list(enq_cls(ds, prefetch=2, num_workers=workers,
                            use_process=use_process).get())

    ref = batches(JDataset, JEnq)
    got = batches(ImageDataset, DatasetEnqueuer)
    assert [len(b["img_names"]) for b in got] == [2, 2, 1]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        np.testing.assert_array_equal(g["imgs"], r["imgs"])
        for k in ("img_names", "img_paths", "scales", "orig_hws"):
            assert g[k] == r[k], k
    # the first batch pads the 64x100 image to the 64x128 one
    assert got[0]["imgs"].shape == (2, 64, 128, 3)
    assert not got[0]["imgs"][1, :, 100:].any()


# --------------------------------------------------------------------------
# the CLI


def _jax_main(monkeypatch, argv, cache_dir):
    """JAX's CLI main with the exact XLA ROIAlign and top-k, and its
    runner's temporal-delta transfer off: that lossless encoding carries
    the previous batch's last frame on the device and fails when two
    batches differ in shape, as mixed image sizes padded per batch do
    (it changes no value where it works). Its weights come straight from
    the npz (``load_npz_tree``): JAX's ``load_npz`` lays them over an eager
    ``init_params``, 15-25 s on the CPU, and the npz holds every leaf."""
    real = jcli.build_config

    def exact(args):
        return dataclasses.replace(real(args), roi_align_impl="xla",
                                   rpn_topk_recall=1.0)

    monkeypatch.setenv("ODT_COMPILE_CACHE", cache_dir)
    monkeypatch.setattr(jcli, "build_config", exact)
    monkeypatch.setattr(jcli, "DetectionRunner",
                        partial(JRunner, temporal_delta=False))
    monkeypatch.setattr(jweights, "load_weights",
                        lambda path, model: jweights.load_npz_tree(path))
    jcli.main(argv)


def _read(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as f:
            out[name] = json.load(f)
    return out


def _agree(got_dir, ref_dir):
    """The module note's rule; returns (matched, total)."""
    got, ref = _read(got_dir), _read(ref_dir)
    assert sorted(got) == sorted(ref)
    matched = total = 0
    for name, rows in ref.items():
        cand = list(got[name])
        for r in rows:
            total += 1
            for i, g in enumerate(cand):
                if (g["category_id"] == r["category_id"]
                        and np.allclose(g["bbox"], r["bbox"], rtol=0,
                                        atol=0.02 + 1e-6)):
                    assert abs(g["score"] - r["score"]) <= 1e-5, name
                    assert g["cat_name"] == r["cat_name"]
                    assert g["segmentation"] is r["segmentation"] is None
                    matched += 1
                    del cand[i]
                    break
    assert total > 0
    assert matched >= 0.98 * total, (matched, total)
    return matched, total


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on the five PNGs: R18 (all classes, then --person_only)
    and EfficientDet; returns the temp dir."""
    tmp = tmp_path_factory.mktemp("imgs_cli")
    paths = write_pngs(str(tmp))
    lst = tmp / "imgs.lst"
    lst.write_text("\n".join(paths) + "\n")
    mp = pytest.MonkeyPatch()
    try:
        jargs = jcli.get_args(["--img_lst", str(lst), "--out_dir", "x"]
                              + ARGV)
        cfg = jcli.build_config(jargs)
        tree = option_tree(cfg)
        tree["fastrcnn"]["outputs"]["class"]["b"][
            cfg.classname2id["Person"]] += 1.0
        save_npz_tree(str(tmp / "r18.npz"), tree)
        ecfg = jcli.build_config(jcli.get_args(
            ["--img_lst", str(lst), "--out_dir", "x"] + EFFDET))
        calib = np.random.RandomState(3).randint(0, 255, (4, 128, 128, 3))
        _, etree = effdet_params(ecfg, calib.astype(np.uint8))
        save_npz_tree(str(tmp / "effdet.npz"), etree)
        cache = str(tmp / "xla_cache")
        for name, argv in (
                ("r18", ARGV + ["--model_path", str(tmp / "r18.npz")]),
                ("person", ARGV + ["--model_path", str(tmp / "r18.npz"),
                                   "--person_only"]),
                ("effdet", EFFDET + ["--model_path",
                                     str(tmp / "effdet.npz")])):
            base = ["--img_lst", str(lst)] + argv
            _jax_main(mp, base + ["--out_dir", str(tmp / "jax" / name)],
                      cache)
            n = tcli.main(base + ["--out_dir", str(tmp / "torch" / name),
                                  "--device", "cpu"])
            assert n == len(SIZES)
    finally:
        mp.undo()
    return tmp


def test_cli_json_matches_jax(runs):
    matched, total = _agree(runs / "torch" / "r18", runs / "jax" / "r18")
    assert sorted(os.listdir(runs / "torch" / "r18")) == [
        f"im{i}.json" for i in range(len(SIZES))]


def test_cli_person_only_matches_jax(runs):
    _agree(runs / "torch" / "person", runs / "jax" / "person")
    for rows in _read(runs / "torch" / "person").values():
        assert all(r["cat_name"] == "Person" for r in rows)


def test_cli_efficientdet_matches_jax(runs):
    _agree(runs / "torch" / "effdet", runs / "jax" / "effdet")


def test_cli_refuses_small_object_head_and_missing_gpu(tmp_path):
    base = ["--img_lst", "x", "--out_dir", str(tmp_path)]
    args = tcli.get_args(base + ["--use_gn", "--use_deformable",
                                 "--add_relation_nn", "--use_att_frcnn_head",
                                 "--use_conv_frcnn_head"])
    cfg = tcli.build_config(args, torch.device("cpu"))
    assert (cfg.use_gn, cfg.use_deformable, cfg.add_relation_nn,
            cfg.use_att_frcnn_head, cfg.use_conv_frcnn_head) == (True,) * 5
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.main(base)


# --------------------------------------------------------------------------
# extract_box_feat


def test_extract_box_feat_matches_jax():
    """Mean-pooled ROI features of the caller's boxes (some past the
    image, one of zero area) against JAX's, the port through the kernel
    wrapper (its plain version on the CPU)."""
    cfg = CONFIGS["r18"]()
    tree = option_tree(cfg)
    rng = np.random.RandomState(5)
    imgs = rng.randint(0, 256, (2, H, W, 3)).astype(np.uint8)
    xy = rng.uniform(-10, W - 10, (2, 9, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 50, (2, 9, 2))], -1)
    boxes[1, 0] = [20, 20, 20, 20]
    boxes = boxes.astype(np.float32)
    ref = jax.jit(jax_model(cfg).extract_box_feat)(tree, imgs, boxes)
    tm = params_from_jax(tree, get_model(port_config(
        cfg, roi_align_impl="pallas")))
    got = tm.extract_box_feat(torch.from_numpy(imgs), torch.from_numpy(boxes))
    assert got.shape == (2, 9, 256)
    close(got.numpy(), ref)
