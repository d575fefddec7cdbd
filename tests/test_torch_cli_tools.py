"""The port's tooling against the JAX package's, on the CPU, on the same
inputs: the utilization logger (runtime/profiler.py) and its plot
(cli/generate_util_graph.py), ``cli/main.py test`` (JAX ``mode_test``'s AP
on the same tiny R18, list and weights, from an npz and from the port's
own ``.pt`` checkpoint) and ``forward`` (exit code 2), the COCO training
dataset (data/coco.py), and the tooling CLIs (eval, eval_mot,
track_to_json, vis_json, vis_tracks, get_frames_resize,
check_and_vis_global_tracks, kf1_convert): the same files, byte for byte,
and the same standard output."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")
import torch  # noqa: E402

from object_detection_tracking_tpu.utils.masks import rle_encode  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import option_tree  # noqa: E402

JAX_PKG = "object_detection_tracking_tpu"
PORT = JAX_PKG + "_torch"


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def run_both(name, argv_of, tmp_path, make_dir=False):
    """``cli.<name>.main(argv_of(out))`` of each package, each with its own
    output path ``out`` (a directory made first with ``make_dir``);
    returns [(return value, stdout with ``out`` as <out>, {file: bytes}
    under ``out``)] for JAX, then the port."""
    import importlib
    res = []
    for pkg in (JAX_PKG, PORT):
        mod = importlib.import_module(f"{pkg}.cli.{name}")
        out = str(tmp_path / f"out_{pkg}")
        if make_dir:
            os.makedirs(out)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = mod.main(argv_of(out))
        res.append((ret, buf.getvalue().replace(out, "<out>"),
                    tree_bytes(out) if os.path.isdir(out) else
                    ({"": open(out, "rb").read()} if os.path.exists(out)
                     else {})))
    return res


def assert_same(res, want_files=True):
    (ret_j, out_j, files_j), (ret_t, out_t, files_t) = res
    assert ret_t == ret_j
    assert out_t == out_j
    assert sorted(files_t) == sorted(files_j)
    for k in files_j:
        assert files_t[k] == files_j[k], k
    if want_files:
        assert files_j


def write_video(path, n_frames=6, h=48, w=64):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    for i in range(n_frames):
        frame = np.full((h, w, 3), 30, np.uint8)
        cv2.rectangle(frame, (4 + 3 * i, 6), (20 + 3 * i, 30),
                      (200, 90, 40), -1)
        vw.write(frame)
    vw.release()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two cv2-written clips, their list, and Person/Vehicle MOT files
    (the 8th column a global id on the Person rows)."""
    root = tmp_path_factory.mktemp("clips")
    vdir = root / "videos"
    vdir.mkdir()
    for name, n in (("a", 6), ("b", 4)):
        write_video(str(vdir / f"{name}.mp4"), n)
        for cat, rows in {
                "Person": "".join(f"{t},1,{5 + 3 * t},6,16,24,1,7,-1,-1\n"
                                  for t in range(n)),
                "Vehicle": "0,2,30,20,20,12,0.8,-1,-1,-1\n"
                           "2,2,31,20,20,12,0.9,-1,-1,-1\n"}.items():
            d = root / "tracks" / name / cat
            d.mkdir(parents=True)
            (d / f"{name}.txt").write_text(rows)
    (root / "videos.lst").write_text("a.mp4\nb.mp4\n")
    return root


# --------------------------------------------------------------------------
# the utilization logger


def test_performance_logger_matches_jax(tmp_path):
    """The same series give the JAX logger's summary and saved file; a
    sample has JAX's keys; the CPU device samples 0 device bytes."""
    from object_detection_tracking_tpu.runtime.profiler import \
        PerformanceLogger as J
    from object_detection_tracking_tpu_torch.runtime import \
        PerformanceLogger as T
    series = {"time": [1.0, 2.0, 3.0], "cpu_percent": [10.0, 30.0, 20.0],
              "rss_mb": [100.0, 120.0, 110.0], "device_bytes": [0., 5., 2.]}
    j, t = J(), T(device="cpu")
    j.series = {k: list(v) for k, v in series.items()}
    t.series = {k: list(v) for k, v in series.items()}
    assert t.summary() == j.summary()
    j.save(str(tmp_path / "j.json"))
    t.save(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert J().summary() == T().summary() == {}
    t = T(interval=0.01, device="cpu").start()
    while not t.series["time"]:
        pass
    t.end()
    assert sorted(t.series) == sorted(series) and t.series[
        "device_bytes"][0] == 0.0
    assert sorted(t.summary()) == sorted(j.summary())


def test_start_trace_writes_a_trace(tmp_path):
    from object_detection_tracking_tpu_torch.runtime import profiler
    profiler.start_trace(str(tmp_path / "trace"))
    torch.ones(8).sum()
    path = profiler.stop_trace()
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        assert "traceEvents" in json.load(f)


def test_generate_util_graph_matches_jax(tmp_path):
    log = tmp_path / "util.json"
    log.write_text(json.dumps({
        "time": [0.0, 5.0, 10.0], "cpu_percent": [10.0, 50.0, 30.0],
        "rss_mb": [100.0, 120.0, 110.0], "device_bytes": [0.0, 2e9, 1e9]}))
    res = run_both("generate_util_graph", lambda out: [
        str(log), os.path.join(out, "util.png")], tmp_path, make_dir=True)
    assert_same(res, want_files=False)


# --------------------------------------------------------------------------
# cli/main.py test and forward


H, W = 48, 64
SMALL = ["--resnet18", "--short_edge_size", str(H), "--max_size", str(W),
         "--rpn_test_post_nms_topk", "32", "--result_per_im", "8",
         "--version", "2", "--compute_dtype", "float32"]


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """A validation list of 6 synthetic frames (JAX data/synthetic.py,
    objects of 26-40 px, the size of P2's anchors) and one tree for both
    packages: the port's init with each residual branch's last BN gamma
    x0.2 (torch_port_common.option_tree) and +2 on the Person, Vehicle and
    Bike logits, so that some detections land on the gt."""
    from object_detection_tracking_tpu.cli import main as jmain
    from object_detection_tracking_tpu.data.synthetic import \
        generate_dataset
    from object_detection_tracking_tpu_torch.params import save_npz_tree
    tmp = tmp_path_factory.mktemp("eval")
    lst = generate_dataset(str(tmp / "data"), 6, image_hw=(H, W), seed=3,
                           size_range=(26, 40), max_objects=2)
    flags = ["--vallst", lst, "--framepath", str(tmp / "data" / "frames"),
             "--annopath", str(tmp / "data" / "anno")] + SMALL
    cfg, _ = jmain.build(jmain.get_args(["test"] + flags), is_train=False)
    tree = option_tree(cfg)
    bias = tree["fastrcnn"]["outputs"]["class"]["b"]
    for name in ("Person", "Vehicle", "Bike"):
        bias[cfg.classname2id[name]] += 2.0
    npz = str(tmp / "weights.npz")
    save_npz_tree(npz, tree)
    return tmp, flags, npz, tree


def jax_mode_test_ap(flags, npz, tree, monkeypatch):
    """JAX ``mode_test``'s AP on ``npz``, its model with the exact
    reference ROIAlign and top-k (roi_align_impl "xla", rpn_topk_recall
    1.0: the Pallas kernel's interpret mode traces for ~20 s) and its
    loader starting from ``tree`` (every leaf is in the npz)."""
    import copy
    import dataclasses
    from object_detection_tracking_tpu.cli import main as jmain
    from object_detection_tracking_tpu.models import get_model as jax_model
    real_build, real_eval, aps = jmain.build, jmain.run_eval, []

    def build(args, is_train):
        cfg, _ = real_build(args, is_train)
        cfg = dataclasses.replace(cfg, roi_align_impl="xla",
                                  rpn_topk_recall=1.0)
        model = jax_model(cfg)
        model.init_params = lambda key: copy.deepcopy(tree)
        return cfg, model

    def run_eval(*a, **k):
        aps.append(real_eval(*a, **k))
        return aps[-1]
    monkeypatch.setattr(jmain, "build", build)
    monkeypatch.setattr(jmain, "run_eval", run_eval)
    jmain.mode_test(jmain.get_args(["test", "--load_from", npz] + flags))
    return aps[0]


def test_main_test_mode_matches_jax_ap(eval_setup, monkeypatch, capsys):
    from object_detection_tracking_tpu_torch.cli import main as M
    tmp, flags, npz, tree = eval_setup
    ref = jax_mode_test_ap(flags, npz, tree, monkeypatch)
    capsys.readouterr()
    got = M.mode_test(M.get_args(["test", "--load_from", npz, "--device",
                                  "cpu"] + flags))
    assert "eval AP" in capsys.readouterr().out
    assert ref > 0
    assert got == pytest.approx(ref, abs=1e-6)
    # the port's own checkpoint of the same weights gives the same AP
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import params_from_jax
    cfg = M.build_config(M.get_args(["test"] + flags), False,
                         torch.device("cpu"))
    model = params_from_jax(tree, get_model(cfg))
    pt = str(tmp / "step_3.pt")
    torch.save({"params": model.state_dict(), "step": 3}, pt)
    assert M.mode_test(M.get_args(["test", "--load_from", pt, "--device",
                                   "cpu"] + flags)) == got


def test_main_forward_mode_exits_2_as_jax(capsys):
    from object_detection_tracking_tpu.cli import main as jmain
    from object_detection_tracking_tpu_torch.cli import main as M
    codes = []
    for mod in (jmain, M):
        with pytest.raises(SystemExit) as e:
            mod.main(["forward"])
        codes.append((e.value.code, capsys.readouterr().err))
    assert codes[1] == codes[0] and codes[0][0] == 2


# --------------------------------------------------------------------------
# data/coco.py


@pytest.mark.parametrize("masks", [False, True])
def test_coco_dataset_matches_jax(tmp_path, masks):
    from object_detection_tracking_tpu.data.coco import CocoTrainDataset as J
    from object_detection_tracking_tpu_torch.data.coco import \
        CocoTrainDataset as T
    rng = np.random.RandomState(0)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"im{i}.png"),
                    rng.randint(0, 256, (40, 60, 3)).astype(np.uint8))
    ann = [{"image_id": 1 + i % 3, "category_id": 7 if i % 4 else 9,
            "bbox": [2 + 3 * i, 4 + i, 12 + i, 10 + 2 * i], "iscrowd": 0,
            "segmentation": [[2 + 3 * i, 4 + i, 14 + 4 * i, 4 + i,
                              8 + 3 * i, 14 + 3 * i]]} for i in range(8)]
    coco = {"images": [{"id": i + 1, "file_name": f"im{i}.png"}
                       for i in range(3)],
            "categories": [{"id": 7, "name": "car"},
                           {"id": 9, "name": "person"}],
            "annotations": ann}
    (tmp_path / "ann.json").write_text(json.dumps(coco))
    out = []
    for cls in (J, T):
        ds = cls(str(tmp_path / "ann.json"), str(tmp_path),
                 {"BG": 0, "Vehicle": 1, "Person": 2}, 40, 60,
                 name_mapping={"car": "Vehicle", "person": "Person"},
                 batch_size=1, max_gt=4, shuffle=False, flip_prob=0.0,
                 with_masks=masks)
        out.append([b for b in ds.batches()])
    assert len(out[1]) == len(out[0]) == 3
    for bj, bt in zip(*out):
        assert len(bt) == len(bj) == (5 if masks else 4)
        for a, b in zip(bj, bt):
            np.testing.assert_array_equal(b, a)


# --------------------------------------------------------------------------
# the tooling CLIs


def test_eval_cli_matches_jax(tmp_path):
    """Per-frame gt npz and detection json (jittered gt boxes, a miss, a
    false positive, a missing json file) through both eval CLIs."""
    rng = np.random.RandomState(1)
    names = [f"v_F_{i:08d}" for i in range(5)]
    (tmp_path / "gt").mkdir()
    (tmp_path / "dt").mkdir()
    (tmp_path / "files.lst").write_text("".join(
        f"frames/{n}.jpg\n" for n in names))
    for i, n in enumerate(names):
        boxes = rng.rand(3, 2) * 50
        boxes = np.concatenate([boxes, boxes + 10 + rng.rand(3, 2) * 30], 1)
        labels = np.array(["Person", "Vehicle", "Bike"])
        np.savez(tmp_path / "gt" / f"{n}.npz", boxes=boxes, labels=labels)
        if i == 4:
            continue                                  # no output file
        dets = [{"category_id": 1, "cat_name": str(l), "score":
                 float(rng.rand()), "bbox": [float(v) for v in np.r_[
                     b[:2] + rng.randn(2), b[2:] - b[:2]]]}
                for b, l in zip(boxes[:2], labels[:2])]
        dets.append({"category_id": 2, "cat_name": "Person", "score": 0.3,
                     "bbox": [100.0, 100.0, 20.0, 20.0]})
        (tmp_path / "dt" / f"{n}.json").write_text(json.dumps(dets))
    res = run_both("eval", lambda out: [
        str(tmp_path / "files.lst"), str(tmp_path / "gt"),
        str(tmp_path / "dt"), "--eval_target", "Person,Vehicle,Bike",
        "--coco_eval"], tmp_path)
    assert_same(res, want_files=False)
    assert "mean AP" in res[0][1] and "cocoAP" in res[0][1]


def test_eval_mot_cli_matches_jax(tmp_path, clips):
    hyp = tmp_path / "hyp"
    for name in ("a", "b"):
        d = hyp / name / "Person"
        d.mkdir(parents=True)
        src = (clips / "tracks" / name / "Person" / f"{name}.txt")
        rows = src.read_text().splitlines()
        (d / f"{name}.txt").write_text("\n".join(
            r.replace(",1,", ",2,", 1) if i > 2 else r
            for i, r in enumerate(rows)))
    res = run_both("eval_mot", lambda out: [
        str(clips / "tracks"), str(hyp), "--videonamelst",
        str(clips / "videos.lst"), "--classes", "Person",
        "--out_json", out], tmp_path)
    assert_same(res)
    assert res[0][0]["idsw"] >= 1


def test_track_to_json_cli_matches_jax(tmp_path, clips):
    res = run_both("track_to_json", lambda out: [
        str(clips / "tracks"), str(clips / "videos.lst"), "Person", out],
        tmp_path)
    assert_same(res)
    assert len(res[0][2]) == 10


def test_vis_json_cli_matches_jax(tmp_path, clips):
    jdir = tmp_path / "json" / "a"
    jdir.mkdir(parents=True)
    mask = np.zeros((48, 64), np.uint8)
    mask[10:30, 10:40] = 1
    for i in range(6):
        jdir.joinpath(f"{i}.json").write_text(json.dumps([
            {"category_id": 1, "cat_name": "Person", "score": 0.9,
             "bbox": [10 + i, 10, 30, 20], "segmentation": rle_encode(mask)},
            {"category_id": 2, "cat_name": "Vehicle", "score": 0.2,
             "bbox": [40, 5, 10, 10], "segmentation": None}]))
    (tmp_path / "a.lst").write_text("a.mp4\n")
    res = run_both("vis_json", lambda out: [
        str(tmp_path / "a.lst"), "--video_dir", str(clips / "videos"),
        "--jsonpath", str(tmp_path / "json"), "--despath", out,
        "--show_mask", "--frame_gap", "2"], tmp_path)
    assert_same(res)


@pytest.mark.parametrize("extra", [[], ["--show_only_global"],
                                   ["--to_video", "--video_size", "128x96"]])
def test_vis_tracks_cli_matches_jax(tmp_path, clips, extra):
    res = run_both("vis_tracks", lambda out: [
        str(clips / "videos.lst"), "--video_dir", str(clips / "videos"),
        "--trackpath", str(clips / "tracks"), "--cat_name",
        "Person,Vehicle", "--despath", out] + extra, tmp_path)
    assert_same(res)


def test_get_frames_resize_cli_matches_jax(tmp_path, clips):
    res = run_both("get_frames_resize", lambda out: [
        str(clips / "videos.lst"), str(clips / "videos"), out, "--size",
        "96", "--maxsize", "128", "--frame_gap", "2", "--use_2level"],
        tmp_path)
    assert_same(res)
    assert len(res[0][2]) == 5


def test_check_and_vis_global_tracks_cli_matches_jax(tmp_path, clips):
    res = run_both("check_and_vis_global_tracks", lambda out: [
        str(clips / "videos.lst"), "--video_dir", str(clips / "videos"),
        "--trackpath", str(clips / "tracks"), "--despath", out,
        "--frame_gap", "2", "--tile_width", "80"], tmp_path)
    assert_same(res)
    assert len(res[0][2]) == 3


def test_kf1_convert_cli_matches_jax(tmp_path):
    pytest.importorskip("yaml")
    from tests.test_kf1 import CLIP, _write_fixture
    _write_fixture(str(tmp_path / "ann"))
    (tmp_path / "clips.lst").write_text(CLIP + "\n")
    res = run_both("kf1_convert", lambda out: [
        str(tmp_path / "ann"), out, "--video_lst",
        str(tmp_path / "clips.lst")], tmp_path)
    assert_same(res)
    assert sorted(res[0][2]) == ["file-index.json", "reference.json"]


def test_cli_tools_import_without_jax():
    """The copied CLIs and data modules resolve their imports into the
    port: none of them pulls a module of the JAX package in."""
    import subprocess
    code = ("import sys\nsys.modules['jax'] = None\n"
            f"sys.modules['{JAX_PKG}'] = None\n"
            + "".join(f"import {PORT}.cli.{n}\n" for n in (
                "eval", "eval_mot", "track_to_json", "vis_json",
                "vis_tracks", "get_frames_resize",
                "check_and_vis_global_tracks", "kf1_convert",
                "generate_util_graph"))
            + f"import {PORT}.data.coco, {PORT}.data.kf1\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
