"""The port's tracking quality proof against the JAX package's, on the CPU.

- the in-memory moving-shapes video (``data/synthetic_np.py
  generate_video``) against JAX's ``data/synthetic.py generate_video``: the
  frames JAX hands its mp4 writer, captured in the test, bit for bit, and
  the ground truth, in normal and hard mode;
- the video-domain training scenes (``generate_video_dataset``) against
  JAX's ``.lst`` and annotation files, and their pixels against the
  captured pre-codec frames;
- the ``--video_domain`` mix (counts, prefixes, order) against JAX's
  ``mixed.lst``, and its batches against ``DetectionTrainDataset``'s;
- the proof's scoring against ``evaluate_tracks`` with the JAX proof's
  aggregation, on hand-made tracks;
- a tiny run of the proof for both trackers with ``jax`` and ``cv2``
  blocked;
- the committed ``TORCH_TRACK_QUALITY.json``.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import object_detection_tracking_tpu_torch as port
from object_detection_tracking_tpu_torch.data import synthetic_np as S

PKG = os.path.dirname(port.__file__)
ROOT = os.path.dirname(PKG)
HARD_RANGE = (10, 53)   # the proofs' --hard size range at 160 px


class _Codec:
    """Stands in for cv2's mp4 writer and reader in JAX's
    ``data/synthetic.py``: the writer keeps each frame it is handed (the
    pre-codec frames), the reader returns them, and ``imwrite`` keeps each
    image by name."""

    def __init__(self, monkeypatch):
        import cv2
        self.videos, self.images = {}, {}
        codec = self

        class Writer:
            def __init__(self, path, *args):
                self.frames = codec.videos.setdefault(path, [])

            def write(self, frame):
                self.frames.append(frame.copy())

            def release(self):
                pass

        class Capture:
            def __init__(self, path):
                self.frames = list(codec.videos[path])

            def read(self):
                if not self.frames:
                    return False, None
                return True, self.frames.pop(0)

            def release(self):
                pass

        def imwrite(path, img, *args):
            name = os.path.splitext(os.path.basename(path))[0]
            codec.images[name] = img.copy()
            return True
        monkeypatch.setattr(cv2, "VideoWriter", Writer)
        monkeypatch.setattr(cv2, "VideoCapture", Capture)
        monkeypatch.setattr(cv2, "imwrite", imwrite)


@pytest.mark.parametrize("size_range", [None, HARD_RANGE])
def test_generate_video_equals_jax(tmp_path, monkeypatch, size_range):
    """150 frames of 4 objects (the proof's seed 123; and 12 objects of
    seed 5): every pixel JAX hands its writer, and the ground truth."""
    from object_detection_tracking_tpu.data import synthetic as J
    codec = _Codec(monkeypatch)
    for n_obj, seed in ((4, 123), (12, 5)):
        path, gt = J.generate_video(str(tmp_path / f"v{seed}"),
                                    num_frames=150, image_hw=(160, 160),
                                    num_objects=n_obj, seed=seed,
                                    size_range=size_range)
        video, got_gt = S.generate_video(150, (160, 160), n_obj, seed,
                                         size_range)
        assert got_gt == gt
        assert video.num_frames == 150 and video.fps == 30.0
        frames = [f for f in video]
        assert len(frames) == len(codec.videos[path]) == 150
        for t, (f, ref) in enumerate(zip(frames, codec.videos[path])):
            assert f.dtype == np.uint8 and f.shape == (160, 160, 3)
            np.testing.assert_array_equal(f, ref, err_msg=str(t))
        assert len({c for fr in gt.values() for _, _, c in fr}) >= 2
    video.seek(0)
    np.testing.assert_array_equal(video.read()[1], frames[0])


def _jax_video_scenes(out, n, codec, **kw):
    """JAX's generate_video_dataset's names, annotations and written
    images."""
    from object_detection_tracking_tpu.data import synthetic as J
    lst = J.generate_video_dataset(out, n, image_hw=(160, 160), **kw)
    names = [ln.strip() for ln in open(lst) if ln.strip()]
    return [(name, codec.images[name], dict(np.load(
        os.path.join(out, "anno", name + ".npz")))) for name in names]


@pytest.mark.parametrize("size_range", [None, HARD_RANGE])
def test_generate_video_dataset_equals_jax(tmp_path, monkeypatch,
                                           size_range):
    """The proof's train clips (24 frames, every 3rd) and val clips (12,
    every 6th): names, boxes and labels equal JAX's files, and the pixels
    equal the pre-codec frames at the sampled indices."""
    codec = _Codec(monkeypatch)
    for kw in (dict(seed=0, prefix="trv", frames_per_video=24,
                    sample_every=3, num_images=20),
               dict(seed=777, prefix="va", frames_per_video=12,
                    sample_every=6, num_images=7)):
        n = kw.pop("num_images")
        ref = _jax_video_scenes(str(tmp_path / kw["prefix"]), n, codec,
                                size_range=size_range, **kw)
        got = S.generate_video_dataset(n, (160, 160), size_range=size_range,
                                       **kw)
        assert [s.name for s in got] == [name for name, _, _ in ref]
        for scene, (name, image, anno) in zip(got, ref):
            assert sorted(scene.anno) == sorted(anno) == ["boxes", "labels"]
            for key in anno:
                assert scene.anno[key].dtype == anno[key].dtype, key
                np.testing.assert_array_equal(scene.anno[key], anno[key])
            np.testing.assert_array_equal(scene.image, image)
            _, vid, fi = name.split("_")
            clip = os.path.join(str(tmp_path / kw["prefix"]), "_clips",
                                f"v{vid}", "track_video.mp4")
            np.testing.assert_array_equal(
                scene.image, codec.videos[clip][int(fi)])
    with pytest.raises(RuntimeError, match="no sampled frames"):
        S.generate_video_dataset(2, (160, 160), frames_per_video=0)


class _Stop(Exception):
    pass


def test_video_domain_mix_equals_jax(tmp_path, monkeypatch):
    """``--video_domain --hard``: the training list (video frames first,
    then stills) and the val list equal JAX's mixed.lst and va.lst, scene
    for scene; the mixed, mask-less scenes batch as
    ``DetectionTrainDataset`` batches JAX's files."""
    from object_detection_tracking_tpu.cli import main as jdriver
    from object_detection_tracking_tpu.cli import quality_proof as JQ
    from object_detection_tracking_tpu_torch.cli import quality_proof as TQ
    from object_detection_tracking_tpu_torch.config import DetectorConfig
    from object_detection_tracking_tpu_torch.data.training import \
        DetectionTrainDataset
    codec = _Codec(monkeypatch)

    def stop(args):
        raise _Stop
    monkeypatch.setattr(jdriver, "mode_train", stop)
    argv = ["--hard", "--video_domain", "--train_images", "13",
            "--val_images", "5"]
    with pytest.raises(_Stop):
        JQ.main(["--workdir", str(tmp_path)] + argv)
    train, val = TQ.render_scenes(TQ.get_args(argv))
    for scenes, lst in ((train, tmp_path / "train" / "mixed.lst"),
                        (val, tmp_path / "val" / "va.lst")):
        names = [ln.strip() for ln in open(lst) if ln.strip()]
        assert [s.name for s in scenes] == names
        for s in scenes:
            anno = dict(np.load(str(lst.parent / "anno" / (s.name +
                                                           ".npz"))))
            assert sorted(s.anno) == sorted(anno)
            for key in anno:
                np.testing.assert_array_equal(s.anno[key], anno[key])
            np.testing.assert_array_equal(s.image, codec.images[s.name])
    assert [s.name[:3] for s in train] == ["trv"] * 6 + ["tr0"] * 7
    assert "masks" in train[-1].anno and "masks" not in train[0].anno

    # the JAX files as lossless PNG for DetectionTrainDataset
    import cv2
    monkeypatch.undo()
    frames = tmp_path / "train" / "png"
    frames.mkdir()
    for s in train:
        assert cv2.imwrite(str(frames / (s.name + ".png")), s.image)
    c2i = DetectorConfig.from_version(2, num_class=16).classname2id
    for with_masks in (False, True):
        kw = dict(batch_size=4, max_gt=8, with_masks=with_masks)
        ref = list(DetectionTrainDataset(
            str(tmp_path / "train" / "mixed.lst"), str(frames),
            str(tmp_path / "train" / "anno"), c2i, 160, 160,
            **kw).batches(2))
        got = list(S.MemoryDetectionDataset(train, c2i, 160, 160,
                                            **kw).batches(2))
        assert len(got) == len(ref) == 6
        for g, r in zip(got, ref):
            assert len(g) == len(r) == 4 + with_masks
            for a, b in zip(g, r):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _write_mot(path, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write("%d,%d,%.2f,%.2f,%.2f,%.2f,1,-1,-1,-1\n" % tuple(r))


def test_score_tracks_equals_the_jax_aggregation(tmp_path):
    """Two classes of hand-made tracks (an id switch, a miss, a false
    positive, a box off by a few px, a class with no file): the port's
    score equals evaluate_tracks per class, summed as JAX's proof sums
    them (its track_and_score)."""
    from object_detection_tracking_tpu.evaluation_mot import (
        evaluate_tracks, load_mot_txt)
    from object_detection_tracking_tpu_torch.cli import \
        track_quality_proof as T
    gt = {}
    for t in range(10):
        gt[t] = [(0, (10 + 3 * t, 20, 40 + 3 * t, 50), "Vehicle"),
                 (1, (100, 10 + 2 * t, 130, 40 + 2 * t), "Bike"),
                 (2, (60, 90, 80, 110), "Bike"),
                 (3, (5, 5, 25, 25), "Person")]
    rows = {"Vehicle": [], "Bike": []}
    for t in range(10):
        rows["Vehicle"].append([t, 7 if t < 6 else 8, 10 + 3 * t, 20, 30,
                                30])
        if t != 4:
            rows["Bike"].append([t, 3, 100, 12 + 2 * t, 30, 30])
        rows["Bike"].append([t, 4, 60, 90, 20, 20])
        if t % 3 == 0:
            rows["Bike"].append([t, 9, 0, 140, 15, 15])
    tdir = str(tmp_path / "tracks")
    for cls, r in rows.items():
        _write_mot(os.path.join(tdir, "track_video", cls,
                                "track_video.txt"), r)
    classes = ["Bike", "Person", "Vehicle"]
    mota, idf1, motp, totals, per_class = T.score_tracks(gt, classes, tdir)

    # JAX's aggregation over evaluate_tracks
    ref_tot = dict(fn=0, fp=0, idsw=0, n_gt=0, idtp=0, idfp=0, idfn=0)
    iou_w, n_match, ref_pc = 0.0, 0, {}
    for cls in classes:
        gt_c = {t: [(i, b) for i, b, c in fr if c == cls]
                for t, fr in gt.items()}
        txt = os.path.join(tdir, "track_video", cls, "track_video.txt")
        m = evaluate_tracks(gt_c, load_mot_txt(txt)
                            if os.path.exists(txt) else {})
        ref_pc[cls] = {k: round(float(v), 4) for k, v in m.items()}
        for k in ref_tot:
            ref_tot[k] += m[k]
        iou_w += m["motp"] * m["n_matches"]
        n_match += m["n_matches"]
    assert per_class == ref_pc and totals == ref_tot
    assert mota == 1.0 - (ref_tot["fn"] + ref_tot["fp"] + ref_tot["idsw"]
                          ) / ref_tot["n_gt"]
    assert idf1 == 2.0 * ref_tot["idtp"] / (
        2 * ref_tot["idtp"] + ref_tot["idfp"] + ref_tot["idfn"])
    assert motp == iou_w / n_match
    assert ref_tot["idsw"] == 1 and ref_tot["fp"] > 0 and \
        per_class["Person"]["mota"] == 0.0 and 0 < mota < 1


SCHEMA = {"mota", "idf1", "motp", "idsw", "fn", "fp", "n_gt", "min_mota",
          "min_idf1", "passed", "min_class_mota", "min_class_idf1", "hard",
          "per_class", "reference_parity", "tracker", "num_frames",
          "num_objects", "trained_steps", "model", "wall_seconds",
          "detector", "kernel_launches", "device", "torch",
          "compute_dtype", "tf32", "renderer", "pixel_format",
          "jax_reference", "tree_hash"}
# JAX's artifact's fields, all kept
JAX_FIELDS = {"mota", "idf1", "motp", "idsw", "fn", "fp", "n_gt",
              "min_mota", "min_idf1", "passed", "min_class_mota",
              "min_class_idf1", "hard", "per_class", "reference_parity",
              "tracker", "num_frames", "num_objects", "trained_steps",
              "model", "wall_seconds", "tree_hash"}

# the CPU's plain ROIAlign is seconds a call at the proof's ROI counts, and
# the proof renders and evaluates hundreds of scenes: the tiny run cuts
# the ROI counts and the scene counts, nothing else
_CUT = (
    "import dataclasses\n"
    "orig = Q.proof_config\n"
    "Q.proof_config = lambda *a: dataclasses.replace(orig(*a), "
    "rpn_train_pre_nms_topk=64, rpn_train_post_nms_topk=64, "
    "fastrcnn_batch_per_im=32, rpn_test_post_nms_topk=32, "
    "result_per_im=16)\n"
    "dorig = T.detector_config\n"
    "def detector_config(*a):\n"
    "    train_args, cfg = dorig(*a)\n"
    "    return train_args, dataclasses.replace(\n"
    "        cfg, rpn_test_post_nms_topk=32, result_per_im=16)\n"
    "T.detector_config = detector_config\n"
    "qmain = Q.main\n"
    "Q.main = lambda argv: qmain(argv + ['--train_images', '8', "
    "'--val_images', '2', '--batch_size', '2'])\n")


def _run_proof(tmp_path, name, argv):
    out = tmp_path / (name + ".json")
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['cv2'] = None\n"
        "sys.modules['object_detection_tracking_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from object_detection_tracking_tpu_torch.cli import "
        "quality_proof as Q\n"
        "from object_detection_tracking_tpu_torch.cli import "
        "track_quality_proof as T\n"
        + _CUT +
        f"T.main({argv + ['--out_json', str(out)]!r})\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    return proc, (json.loads(out.read_text()) if out.exists() else None)


def test_tiny_proof_runs_on_the_cpu_without_jax_or_cv2(tmp_path):
    """R18 at 64 px, 4 steps, 16 frames, every detection tracked: Deep
    SORT gated at MOTA 1.01 exits 1 with "passed": false; TMOT in the same
    workdir reuses the detector and, gated at -inf, exits 0. Both artifacts
    have the schema, JAX's fields among them, and count the kernel
    launches of each part (0 on the CPU)."""
    work = str(tmp_path / "work")
    base = ["--workdir", work, "--device", "cpu", "--image_size", "64",
            "--steps", "3", "--num_frames", "16", "--min_ap", "0",
            "--min_confidence", "0"]
    proc, out = _run_proof(tmp_path, "ds", base + ["--min_mota", "1.01"])
    assert proc.returncode == 1, proc.stderr
    assert "FAIL: MOTA" in proc.stderr and "phase 1: training" in \
        proc.stdout
    assert set(out) == SCHEMA and JAX_FIELDS <= set(out)
    assert out["passed"] is False and out["tracker"] == "deep_sort"
    assert out["trained_steps"] == 4 and out["n_gt"] > 0
    assert out["detector"]["trained_here"] is True
    assert out["detector"]["train_images"] == 8
    assert set(out["kernel_launches"]["tracking"]) == {
        "tracks", "tracks_refparity"}
    assert out["kernel_launches"]["detector"]["train"][
        "multilevel_roi_align_cuda"] == 0
    assert out["device"] == "cpu" and out["compute_dtype"] == "float32"
    assert out["pixel_format"] == "bgr" and "C12" in out["renderer"]
    assert out["jax_reference"] == "TRACK_QUALITY_r05.json"
    assert np.isfinite(out["mota"]) and out["fp"] + out["fn"] > 0

    proc, out = _run_proof(tmp_path, "tmot", base + [
        "--tracker", "tmot", "--min_mota=-inf", "--min_idf1", "0",
        "--min_class_mota=-inf"])
    assert proc.returncode == 0, proc.stderr
    assert "phase 1: reusing" in proc.stdout
    assert set(out) == SCHEMA and out["passed"] is True
    assert out["tracker"] == "tmot" and out["trained_steps"] == 4
    assert out["detector"]["trained_here"] is False
    assert out["detector"]["ap50"] is not None
    assert set(out["per_class"]) == set(out["reference_parity"]["per_class"])


def test_committed_artifact_records_passing_card_runs():
    """TORCH_TRACK_QUALITY.json holds both trackers' runs at JAX r05's
    settings (hard, 4000 steps, MOTA >= 0.6, IDF1 >= 0.7, every class's
    MOTA >= 0.6), on an NVIDIA card with its power limit, in float32 with
    TF32 off, each passed. Whether its tree_hash is the tree's own is
    printed, not asserted (ROADMAP's freshness rule)."""
    from object_detection_tracking_tpu_torch.utils.source_hash import \
        quality_tree_hash
    with open(os.path.join(ROOT, "TORCH_TRACK_QUALITY.json")) as f:
        art = json.load(f)
    tree = quality_tree_hash()
    for tracker in ("deep_sort", "tmot"):
        out = art[tracker]
        assert set(out) == SCHEMA
        assert out["tracker"] == tracker and out["passed"] is True
        assert (out["min_mota"], out["min_idf1"], out["min_class_mota"]) \
            == (0.6, 0.7, 0.6)
        assert out["mota"] >= 0.6 and out["idf1"] >= 0.7
        assert all(m["mota"] >= 0.6 for m in out["per_class"].values())
        assert out["hard"] is True and out["trained_steps"] == 4000
        assert (out["num_frames"], out["num_objects"]) == (150, 4)
        assert re.fullmatch(r"NVIDIA .+, \d+(\.\d+)? W", out["device"]), \
            out["device"]
        assert out["compute_dtype"] == "float32" and out["tf32"] is False
        assert out["pixel_format"] == "bgr"
        assert out["jax_reference"] == "TRACK_QUALITY_r05.json"
        print(f"TORCH_TRACK_QUALITY.json {tracker}: tree_hash "
              f"{out['tree_hash']} "
              f"{'fresh' if out['tree_hash'] == tree else 'stale'}")
