"""The port's data parallelism (parallel/mesh.py) on the CPU beyond the
R18 train step (test_torch_parallel.py): ``batch_bn`` on two ranks against
JAX's on the whole batch, the EfficientDet step, the sharded ``run_eval``
and ``main.py train`` under two ranks against their one-process runs, and
the runner over two replicas (JAX: the mesh-sharded runner,
tests/test_runner.py:99). One spawn of two gloo ranks
(tests/torch_parallel_workers.py, which imports no JAX) runs the four
distributed jobs, one torch thread each, every group with a 60 s timeout,
joined within 240 s.

EfficientDet against its one-process step: within 1e-4 of each leaf's
largest update plus two float32 steps; its update-invariant leaves
(test_torch_effdet_train.py ``_INVARIANT``: in exact arithmetic their
gradient is zero, in float32 rounding noise) within 1e-4 of the largest
update of any leaf. Batch-statistics BN makes EfficientDet's step
sensitive to the order of its sums: the one-process step run on the same
4 images in another order (2, 3, 0, 1) lands up to 5.2e-5 of a leaf's
largest update beyond two float32 steps from the first, and the 2-rank
step 4.5e-5 (measured on this case).
"""

import itertools
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_detection_tracking_tpu.config import DetectorConfig
from object_detection_tracking_tpu.ops.norm import batch_bn as jax_batch_bn
from object_detection_tracking_tpu_torch.cli import main as M
from object_detection_tracking_tpu_torch.config import TrainConfig
from object_detection_tracking_tpu_torch.data.synthetic import \
    generate_dataset
from object_detection_tracking_tpu_torch.models import get_model
from object_detection_tracking_tpu_torch.params import (init_params,
                                                        params_from_jax,
                                                        params_to_jax)
from object_detection_tracking_tpu_torch.runtime import DetectionRunner
from object_detection_tracking_tpu_torch.train import Trainer
from torch_parallel_workers import (STEP, check_against_one, load_results,
                                    save_inputs, spawn)
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import close, effdet_params, flat

EFFDET = DetectorConfig(model="efficientdet",
                        efficientdet_name="efficientdet-test", num_class=4,
                        compute_dtype="float32", result_per_im=10,
                        roi_align_impl="xla", is_train=True)
_INVARIANT = re.compile(
    r"(^resample/p6|/resample_\d+_\d+_\d+|/fnode\d+/pw|_net/conv\d+/pw)/b$"
    r"|^backbone/group\d+/block\d+/project/bn/beta$"
    r"|^fpn_cells/cell_1/fnode7/bn/beta$")
SMALL_CLI = ["--resnet18", "--short_edge_size", "48", "--max_size", "64",
             "--rpn_train_post_nms_topk", "32", "--rpn_batch_size", "32",
             "--frcnn_batch_size", "16", "--rpn_test_post_nms_topk", "32",
             "--result_per_im", "8", "--version", "2", "--device", "cpu"]

def _effdet_batch(b=4, h=128, w=128, g=6):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 255, (b, h, w, 3)).astype(np.uint8)
    xy = rng.uniform(0, [w - 20, h - 20], (b, g, 2))
    wh = rng.uniform(8, 60, (b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1).astype(
        np.float32)
    labels = rng.randint(1, 4, (b, g)).astype(np.int32)
    valid = np.ones((b, g), bool)
    valid[0, -2:] = False
    boxes[~valid] = 0.0
    labels[~valid] = 0
    return images, boxes, labels, valid


def _mixed_set(data, n, seed):
    """``n`` synthetic images in ``data``, landscape 48x64 and portrait
    64x48 in turns (each keeps its shape through the 48/64 resize); returns
    the lst."""
    a = generate_dataset(data, (n + 1) // 2, image_hw=(48, 64), seed=seed,
                         prefix="a")
    b = generate_dataset(data, n // 2, image_hw=(64, 48), seed=seed + 1,
                         prefix="b")
    names = [open(p).read().split() for p in (a, b)]
    lst = os.path.join(data, "mixed.lst")
    with open(lst, "w") as f:
        f.write("\n".join(x for pair in itertools.zip_longest(*names)
                          for x in pair if x) + "\n")
    return lst


def _val_set(tmp, n=11):
    data = os.path.join(tmp, "val")
    lst = _mixed_set(data, n, seed=3)
    return dict(vallst=lst, valframepath=os.path.join(data, "frames"),
                framepath=os.path.join(data, "frames"),
                valannopath=os.path.join(data, "anno"),
                annopath=os.path.join(data, "anno"), max_gt=8, val_skip=1,
                act_as_obj=False, bupt_exp=False, meva_exp=False)


def _eval_model():
    from object_detection_tracking_tpu_torch.config import \
        DetectorConfig as PortConfig
    cfg = PortConfig(num_class=4, resnet_depth=18, short_edge_size=48,
                     max_size=64, rpn_test_post_nms_topk=32, result_per_im=5,
                     compute_dtype="float32", roi_align_impl="xla")
    return cfg, params_from_jax(init_params(cfg, seed=0), get_model(cfg))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The jobs' inputs, their one-process references and results."""
    tmp = str(tmp_path_factory.mktemp("ranks2"))
    ref = {}
    x = np.random.RandomState(5).randn(4, 8, 6, 5).astype(np.float32) * 3
    bn = dict(x=torch.from_numpy(x), w=torch.from_numpy(
        np.random.RandomState(6).randn(4, 8, 6, 5).astype(np.float32)),
        gamma=torch.linspace(0.5, 1.5, 8), beta=torch.linspace(-1, 1, 8))
    save_inputs(tmp, "batch_bn", **bn)
    ref["bn"] = bn

    ebatch = _effdet_batch()
    em, _ = effdet_params(EFFDET, ebatch[0])
    eb = [torch.from_numpy(v) for v in ebatch] + [None]
    save_inputs(tmp, "train_step", mesh=(2, 1), cfg=em.config,
                state=em.state_dict(), batch=eb, kw=STEP)
    # params_to_jax's 1-D leaves are views of the live params: copy them
    before = {k: v.copy() for k, v in flat(params_to_jax(em)).items()}
    Trainer(em, TrainConfig(**STEP)).step(*eb[:4])
    ref["effdet"] = dict(before=before, one=flat(params_to_jax(em)))

    args = _val_set(tmp)
    cfg, model = _eval_model()
    save_inputs(tmp, "eval", cfg=cfg, state=model.state_dict(), args=args)
    cache = {}
    ref["eval"] = dict(ap=M.run_eval(SimpleNamespace(**args), cfg, model,
                                     cache=cache),
                       scored=cache["scored"])

    data = os.path.join(tmp, "train")
    lst = _mixed_set(data, 4, seed=0)
    argv = ["train", "--trainlst", lst, "--framepath",
            os.path.join(data, "frames"), "--annopath",
            os.path.join(data, "anno"), "--im_batch_size", "2",
            "--num_step", "2", "--save_every", "1", "--freeze", "0"
            ] + SMALL_CLI
    save_inputs(tmp, "train_cli", argv=argv, out=os.path.join(tmp, "cli"))
    res = M.mode_train(M.get_args(argv + ["--outbasepath",
                                          os.path.join(tmp, "one")]))
    ref["cli"] = flat(params_to_jax(res["trainer"].model))

    spawn(["batch_bn", "train_step", "eval", "train_cli"], 2, tmp)
    return tmp, ref


def test_batch_bn_on_two_halves_matches_jax_whole_batch(two_ranks):
    """Each rank normalises its half with the whole batch's statistics:
    outputs, input gradients and the gamma/beta gradients (summed over the
    ranks) equal JAX's batch_bn and jax.grad over the whole batch."""
    tmp, ref = two_ranks
    bn = ref["bn"]
    outs = load_results(tmp, "batch_bn", 2)
    x = jnp.asarray(bn["x"].numpy().transpose(0, 2, 3, 1))
    w = jnp.asarray(bn["w"].numpy().transpose(0, 2, 3, 1))

    def loss(x, gamma, beta):
        y = jax_batch_bn({"gamma": gamma, "beta": beta,
                      "mean": jnp.zeros(8), "variance": jnp.ones(8)}, x)
        return (y * w).sum(), y

    (_, y), (dx, dg, db) = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
        x, jnp.asarray(bn["gamma"].numpy()), jnp.asarray(bn["beta"].numpy()))
    y = np.asarray(y).transpose(0, 3, 1, 2)
    dx = np.asarray(dx).transpose(0, 3, 1, 2)
    close(np.concatenate([o["y"].numpy() for o in outs]), y, rel=1e-5)
    close(np.concatenate([o["dx"].numpy() for o in outs]), dx, rel=1e-5)
    for o in outs:
        close(o["dgamma"].numpy(), np.asarray(dg), rel=1e-5)
        close(o["dbeta"].numpy(), np.asarray(db), rel=1e-5)


def test_effdet_dp_step_matches_one_process(two_ranks):
    """EfficientDet (efficientdet-test, 128 px, B=4, 2 a rank): batch
    statistics summed over the ranks and the focal normaliser counting the
    positives of the whole batch give the one-process step's params."""
    tmp, ref = two_ranks
    ref = ref["effdet"]
    outs = load_results(tmp, "train_step", 2)
    for out in outs:
        check_against_one(out["params"], ref["one"], ref["before"],
                           invariant=_INVARIANT, rel=1e-4)
    assert outs[0]["losses"] == outs[1]["losses"]


def test_sharded_eval_scores_each_image_once(two_ranks):
    """11 validation images, landscape and portrait in turns, over 2 ranks
    (the last batch padded): each rank runs its images unpadded, and every
    rank scores all 11 once, in order, with the one-process eval's
    detections (a batch of 2 padded to the larger image changes them) and
    AP."""
    tmp, ref = two_ranks
    scored = ref["eval"]["scored"]
    assert [i for i, _, _ in scored] == list(range(11))
    assert sum(len(v) for _, dt, _ in scored for v in dt.values()) > 0
    for out in load_results(tmp, "eval", 2):
        assert out["scored"] == scored
        assert out["ap"] == pytest.approx(ref["eval"]["ap"], abs=1e-9)


def test_train_cli_under_two_ranks(two_ranks):
    """``main.py train`` under two gloo ranks (``--device cpu``, the
    launcher's variables set), 2 steps of the global batch of 2 (a
    landscape and a portrait image, each rank decoding its own, padded to
    the whole batch's shape): equal params on both ranks, equal to a
    one-process run's; rank 0 alone wrote the checkpoints and
    final.npz."""
    tmp, ref = two_ranks
    outs = load_results(tmp, "train_cli", 2)
    assert outs[0]["step"] == outs[1]["step"] == 2
    for k, v in outs[0]["params"].items():
        np.testing.assert_array_equal(outs[1]["params"][k], v, err_msg=k)
        np.testing.assert_allclose(v, ref["cli"][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert outs[0]["files"] == ["odt/final.npz", "odt/save/step_1.pt",
                                "odt/save/step_2.pt"]
    assert outs[1]["files"] == []


def test_rank_batches_decode_each_ranks_rows_alone(tmp_path, monkeypatch):
    """``rank_batches`` on 2 data ranks, batches of 4 over 2 epochs of 8
    mixed-shape images with flips, short-edge jitter, mixup and masks:
    each rank gets its rows of every batch, equal to the whole batch's
    within their own extent (zero beyond), decodes only them and their
    mixup partners, and leaves the dataset's random stream where the whole
    batches leave it, with its own loader back."""
    from object_detection_tracking_tpu_torch.data import training
    from object_detection_tracking_tpu_torch.parallel.mesh import (
        Mesh, rank_batches)
    data = str(tmp_path)
    lst = _mixed_set(data, 8, seed=7)

    def dataset():
        return training.DetectionTrainDataset(
            lst, os.path.join(data, "frames"), os.path.join(data, "anno"),
            {"BG": 0, "Person": 1, "Vehicle": 2, "Bike": 3}, 48, 96,
            batch_size=4, max_gt=8, flip_prob=0.5, use_mixup=True,
            with_masks=True, short_edge_jitter=(40, 56), seed=3)

    whole = dataset()
    ref = list(whole.batches(2))
    assert len(ref) == 4
    imread, reads = training.cv2.imread, []
    monkeypatch.setattr(training.cv2, "imread",
                        lambda *a: reads.append(a) or imread(*a))
    for rank in (0, 1):
        ds, rows = dataset(), slice(2 * rank, 2 * rank + 2)
        del reads[:]
        got = list(rank_batches(ds, Mesh(2, 1, rank, None, None,
                                         torch.device("cpu")),
                                2, whole_shape=False))
        assert len(got) == len(ref) and len(reads) == 4 * len(ref)
        for g, r in zip(got, ref):
            h, w = g[0].shape[1:3]
            np.testing.assert_array_equal(g[0], r[0][rows, :h, :w])
            assert not r[0][rows, h:].any() and not r[0][rows, :, w:].any()
            for a, b in zip(g[1:], r[1:]):
                np.testing.assert_array_equal(a, b[rows])
        assert ds.rng.getstate() == whole.rng.getstate()
        assert "_load_one" not in vars(ds)


def test_two_replica_runner_matches_one_device():
    """The runner on ``[cpu, cpu]`` (JAX: the mesh-sharded runner,
    tests/test_runner.py:99) splits each batch of 4 over two replicas and
    returns what the one-device runner does, in batch order; a batch of 3
    runs on the first replica."""
    cfg, model = _eval_model()
    model.eval()
    rng = np.random.RandomState(0)
    batches = [(rng.randint(0, 255, (4, 48, 64, 3)).astype(np.uint8), 0),
               (rng.randint(0, 255, (3, 48, 64, 3)).astype(np.uint8), 1)]
    one = list(DetectionRunner(model).run(iter(batches)))
    runner = DetectionRunner(model, devices=["cpu", "cpu"])
    assert len(runner.replicas) == 2 and runner.replicas[1] is not model
    two = list(runner.run(iter(batches)))
    assert [m for _, m in two] == [0, 1]
    for (a, _), (b, _) in zip(one, two):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_video_cli_splits_batches_over_listed_devices(capsys):
    """``obj_detect_tracking --device cpu,cpu`` builds one replica per
    listed device when ``--im_batch_size`` divides over them (JAX CLI
    :409-419), and one model with a warning when it does not."""
    from object_detection_tracking_tpu_torch.cli import \
        obj_detect_tracking as cli
    base = ["--video_dir", ".", "--video_lst_file", "x", "--resnet18",
            "--short_edge_size", "48", "--max_size", "64",
            "--device", "cpu,cpu"]
    devices = cli.resolve_devices("cpu,cpu")
    assert devices == [torch.device("cpu")] * 2
    for batch, n in (("2", 2), ("3", 1)):
        args = cli.get_args(base + ["--im_batch_size", batch])
        cfg = cli.build_config(args, devices[0])
        runner = cli.build_runner(args, cfg, devices[0], devices)
        assert len(runner.replicas) == n
    err = capsys.readouterr().err
    assert "does not divide over 2 devices" in err
