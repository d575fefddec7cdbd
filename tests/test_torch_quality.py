"""The port's detector quality proof against the JAX package's, on the CPU.

- the numpy scene renderer (``data/synthetic_np.py``) against JAX's
  ``data/synthetic.py generate_dataset`` (its images taken before the JPEG
  write), normal and hard mode;
- the in-memory dataset's batches against ``DetectionTrainDataset``'s over
  the same pixels written as lossless PNG;
- ``fill_full_mask`` (cv2-free in the port) against JAX's, and its resize
  against ``cv2.resize``;
- the proof's train flags and configuration against those JAX's proof
  builds;
- a tiny run of the port's proof with ``jax`` and ``cv2`` blocked;
- ``quality_tree_hash`` moving with the hashed sources;
- the committed ``TORCH_QUALITY_*.json`` artifacts.
"""

import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import object_detection_tracking_tpu_torch as port
from object_detection_tracking_tpu_torch.data import synthetic_np as S

PKG = os.path.dirname(port.__file__)
ROOT = os.path.dirname(PKG)
HARD = dict(size_range=(10, 53), crowding=0.35, overlap_iou=0.45,
            max_objects=8)   # the proof's --hard at 160 px


def _jax_scenes(tmp_path, monkeypatch, n, **kw):
    """JAX's generate_dataset with its images captured before the JPEG
    write; returns {name: (image, annotation dict)}."""
    import cv2
    from object_detection_tracking_tpu.data import synthetic as J
    images = {}

    def capture(path, img, *args):
        images[os.path.splitext(os.path.basename(path))[0]] = img.copy()
        return True
    monkeypatch.setattr(cv2, "imwrite", capture)
    out = str(tmp_path / "jax")
    lst = J.generate_dataset(out, n, image_hw=(160, 160), seed=0,
                             prefix="tr", **kw)
    names = [l.strip() for l in open(lst) if l.strip()]
    return {name: (images[name], dict(np.load(
        os.path.join(out, "anno", name + ".npz")))) for name in names}


@pytest.mark.parametrize("hard", [False, True])
def test_renderer_equals_jax_generate_dataset(tmp_path, monkeypatch, hard):
    """Names, boxes, labels and masks bit for bit; and every pixel of every
    image (background noise and gradient, distractor strokes of width 1
    and 2, circles, squares, triangles) equal to cv2's render."""
    kw = HARD if hard else {}
    ref = _jax_scenes(tmp_path, monkeypatch, 24, **kw)
    got = S.generate_dataset(24, image_hw=(160, 160), seed=0, prefix="tr",
                             **kw)
    assert [s.name for s in got] == list(ref)
    n_obj = 0
    for scene in got:
        image, anno = ref[scene.name]
        assert sorted(scene.anno) == sorted(anno)
        for key in anno:
            assert scene.anno[key].dtype == anno[key].dtype, key
            np.testing.assert_array_equal(scene.anno[key], anno[key])
        assert scene.image.dtype == np.uint8
        np.testing.assert_array_equal(scene.image, image)
        n_obj += len(anno["labels"])
    assert n_obj > (60 if hard else 30)


def test_triangle_mask_and_shapes_equal_cv2():
    """Each primitive against cv2 on random geometry: the 28x28 triangle
    mask, filled circles (clipped at the edges too), triangles, and lines
    of width 1 and 2 between points on the canvas, as the scenes draw
    them (a width-2 line to a point off the canvas is not exact)."""
    import cv2
    from object_detection_tracking_tpu.data import synthetic as J
    for cls in range(3):
        np.testing.assert_array_equal(S.shape_box_mask(cls),
                                      J.shape_box_mask(cls))
    rng = np.random.RandomState(1)
    color = (255, 128, 7)
    for t in range(600):
        ref = np.zeros((96, 128, 3), np.uint8)
        got = ref.copy()
        kind = t % 4
        if kind < 2:
            p = [int(v) for v in (rng.randint(0, 128), rng.randint(0, 96),
                                  rng.randint(0, 128), rng.randint(0, 96))]
            cv2.line(ref, tuple(p[:2]), tuple(p[2:]), color, kind + 1)
            S._thick_line(got, *p, kind + 1, color)
        elif kind == 2:
            cx, cy, r = int(rng.randint(-10, 138)), int(
                rng.randint(-10, 106)), int(rng.randint(0, 40))
            cv2.circle(ref, (cx, cy), r, color, -1)
            S._fill_circle(got, cx, cy, r, color)
        else:
            x, y = (int(v) for v in rng.randint(0, 90, 2))
            size = int(rng.randint(1, 60))
            pts = [(x + size // 2, y), (x, y + size), (x + size, y + size)]
            cv2.fillPoly(ref, [np.array(pts, np.int32)], color)
            S._fill_poly(got, pts, color)
        np.testing.assert_array_equal(got, ref, err_msg=str(t))


def _write_png_dataset(tmp_path, scenes):
    import cv2
    frames, annos = tmp_path / "frames", tmp_path / "anno"
    frames.mkdir()
    annos.mkdir()
    for s in scenes:
        assert cv2.imwrite(str(frames / (s.name + ".png")), s.image)
        np.savez(str(annos / (s.name + ".npz")), **s.anno)
    lst = tmp_path / "x.lst"
    lst.write_text("\n".join(s.name for s in scenes) + "\n")
    return str(lst), str(frames), str(annos)


@pytest.mark.parametrize("with_masks", [False, True])
def test_memory_batches_equal_the_file_dataset(tmp_path, with_masks):
    """Two shuffled, flipped epochs and the padded eval pass of the
    in-memory dataset equal DetectionTrainDataset's over the same pixels
    (lossless PNG files), array for array."""
    from object_detection_tracking_tpu_torch.config import DetectorConfig
    from object_detection_tracking_tpu_torch.data.training import \
        DetectionTrainDataset
    scenes = S.generate_dataset(10, image_hw=(160, 160), seed=3, **HARD)
    lst, frames, annos = _write_png_dataset(tmp_path, scenes)
    c2i = DetectorConfig.from_version(2, num_class=16).classname2id
    for kw, call in [
            (dict(batch_size=4, max_gt=8, with_masks=with_masks),
             dict(epochs=2)),
            (dict(batch_size=3, max_gt=8, shuffle=False, flip_prob=0.0,
                  with_masks=with_masks),
             dict(pad_last=True, yield_batch_valid=True))]:
        ref = list(DetectionTrainDataset(lst, frames, annos, c2i, 160, 160,
                                         **kw).batches(**call))
        got = list(S.MemoryDetectionDataset(scenes, c2i, 160, 160,
                                            **kw).batches(**call))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert len(g) == len(r) == 4 + with_masks + (
                "pad_last" in call)
            for a, b in zip(g, r):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    flipped = {s.image[:, ::-1].tobytes() for s in scenes}
    assert any(im.tobytes() in flipped for b in S.MemoryDetectionDataset(
        scenes, c2i, 160, 160, batch_size=4, max_gt=8).batches(2)
        for im in b[0])


def test_memory_dataset_refuses_a_resize():
    from object_detection_tracking_tpu_torch.config import DetectorConfig
    scenes = S.generate_dataset(2, image_hw=(96, 128), seed=0)
    c2i = DetectorConfig.from_version(2, num_class=16).classname2id
    ds = S.MemoryDetectionDataset(scenes, c2i, 80, 160, batch_size=2)
    with pytest.raises(ValueError, match="resize"):
        next(ds.batches())


def _port_masks_without_cv2(monkeypatch):
    """A fresh copy of the port's utils/masks.py, loaded with cv2
    unimportable."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    spec = importlib.util.spec_from_file_location(
        "port_masks_no_cv2", os.path.join(PKG, "utils", "masks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fill_full_mask_without_cv2_equals_jax(monkeypatch):
    """Boxes from under 1 px to past the frame, over its right and bottom
    edges, up- and downscales, soft and coarse (bf16-like) masks, over
    2000 seeds: the pasted masks equal JAX's cv2 ones."""
    from object_detection_tracking_tpu.utils import masks as jm
    tm = _port_masks_without_cv2(monkeypatch)
    sizes = set()
    for seed in range(2000):
        rng = np.random.RandomState(seed)
        im_hw = (int(rng.randint(20, 200)), int(rng.randint(20, 200)))
        soft = rng.rand(28, 28).astype(np.float32)
        if seed % 3 == 0:
            soft = (np.round(soft * 256) / 256).astype(np.float32)
        lo, hi = [(0.2, 3), (3, 28), (28, 250), (150, 400)][seed % 4]
        w, h = rng.uniform(lo, hi, 2)
        x0 = rng.uniform(-0.49, im_hw[1])
        y0 = rng.uniform(-0.49, im_hw[0])
        box = np.array([x0, y0, x0 + w, y0 + h], np.float32)
        ref = jm.fill_full_mask(box, soft, im_hw)
        got = tm.fill_full_mask(box, soft, im_hw)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=str(seed))
        sizes.add(np.sign(int(w) - 28))
    assert sizes >= {-1, 1}   # downscales and upscales
    # pasted sizes that halve the 28x28 mask on both axes or on one
    # (cv2 may take another path for an exact 2x downscale)
    rng = np.random.RandomState(7)
    for pw, ph in [(14, 14), (14, 28), (28, 14), (14, 9), (7, 7)]:
        for _ in range(50):
            soft = rng.rand(28, 28).astype(np.float32)
            box = np.array([10, 5, 10 + pw, 5 + ph], np.float32)
            ref = jm.fill_full_mask(box, soft, (60, 60))
            got = tm.fill_full_mask(box, soft, (60, 60))
            np.testing.assert_array_equal(got, ref, err_msg=str((pw, ph)))


def test_resize_linear_equals_cv2_bit_for_bit():
    """cv2.resize INTER_LINEAR of a float32 28x28 map to 1..299 px per
    side, and to the exact 2x and 4x downscales, every output value
    equal."""
    import cv2
    from object_detection_tracking_tpu_torch.utils.masks import \
        resize_linear
    rng = np.random.RandomState(1)
    for t in range(600):
        m = rng.rand(28, 28).astype(np.float32)
        if t % 2:
            m = (np.round(m * 256) / 256).astype(np.float32)
        w, h = int(rng.randint(1, 300)), int(rng.randint(1, 300))
        np.testing.assert_array_equal(resize_linear(m, w, h),
                                      cv2.resize(m, (w, h)),
                                      err_msg=str((w, h)))
    # exact 2x downscales on both axes and on one, and a 4x one
    for w, h in [(14, 14), (14, 28), (28, 14), (14, 20), (20, 14), (7, 7)]:
        for _ in range(50):
            m = rng.rand(28, 28).astype(np.float32)
            np.testing.assert_array_equal(resize_linear(m, w, h),
                                          cv2.resize(m, (w, h)),
                                          err_msg=str((w, h)))


class _Stop(Exception):
    pass


PROOFS = {"rcnn": [], "rcnn-hard-mask": ["--hard", "--add_mask"],
          "efficientdet-d0": ["--detector", "efficientdet-d0"],
          "rcnn-hard-video": ["--hard", "--video_domain"]}
# flags that name places on disk: the JAX proof's lst, frames and
# annotations (the port's scenes come from memory) and the run directory
_PATHS = {"trainlst", "framepath", "annopath", "outbasepath"}


@pytest.mark.parametrize("proof", list(PROOFS))
def test_proof_flags_and_config_equal_jax(tmp_path, monkeypatch, proof):
    """The train flags and DetectorConfig the port's proof builds equal
    those the JAX proof hands its driver (captured in mode_train, which
    then stops), but for --device and the train ROIAlign's route
    (ROADMAP C9)."""
    import torch
    from object_detection_tracking_tpu.cli import main as jdriver
    from object_detection_tracking_tpu.cli import quality_proof as JQ
    from object_detection_tracking_tpu_torch.cli import main as tdriver
    from object_detection_tracking_tpu_torch.cli import quality_proof as TQ
    seen = {}

    def capture(args):
        seen["args"] = args
        seen["cfg"], _ = jdriver.build(args, True)
        raise _Stop
    monkeypatch.setattr(jdriver, "mode_train", capture)
    argv = PROOFS[proof] + ["--train_images", "16", "--val_images", "2",
                            "--steps", "30"]
    with pytest.raises(_Stop):
        JQ.main(["--workdir", str(tmp_path)] + argv)
    args = TQ.get_args(["--workdir", str(tmp_path), "--device", "cpu"]
                       + argv)
    targs = tdriver.get_args(TQ.train_flags(args))
    jvars, tvars = vars(seen["args"]), vars(targs)
    assert set(jvars) <= set(tvars)
    assert set(tvars) - set(jvars) == {"device"}
    assert tvars["device"] == "cpu"
    for key in set(jvars) - _PATHS:
        assert tvars[key] == jvars[key], key
    assert tvars["outbasepath"] == jvars["outbasepath"]
    cfg = TQ.proof_config(args, targs, torch.device("cpu"))
    ref = dataclasses.asdict(seen["cfg"])
    got = dataclasses.asdict(cfg)
    assert ref.pop("roi_align_train_impl") == "xla"
    assert got.pop("roi_align_train_impl") == "pallas"
    assert got == ref
    assert cfg.compute_dtype == "float32" and cfg.is_train


SCHEMA = {"ap50", "ap50_exact_topk", "ap50_exact_topk_note",
          "rpn_topk_recall", "min_ap", "passed", "trained_steps",
          "train_images", "val_images", "image_size", "hard", "video_domain",
          "mask_iou", "min_mask_iou", "model", "wall_seconds",
          "train_seconds", "step_ms_median", "train_loss", "kernel_launches",
          "device", "torch", "compute_dtype", "tf32", "renderer",
          "jax_reference", "tree_hash"}

# the CPU's plain ROIAlign over the proof's 512 sampled ROIs a 256-channel
# image is seconds a call: the tiny run cuts the ROI counts, nothing else
_SMALL_ROIS = (
    "import dataclasses\n"
    "orig = Q.proof_config\n"
    "Q.proof_config = lambda *a: dataclasses.replace(orig(*a), "
    "rpn_train_pre_nms_topk=64, rpn_train_post_nms_topk=64, "
    "fastrcnn_batch_per_im=32, rpn_test_post_nms_topk=32, "
    "result_per_im=16)\n")


def _run_proof(tmp_path, name, argv, small_rois=False):
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
        + (_SMALL_ROIS if small_rois else "") +
        f"Q.main({argv + ['--out_json', str(out)]!r})\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    return proc, (json.loads(out.read_text()) if out.exists() else None)


def test_tiny_proof_runs_on_the_cpu_without_jax_or_cv2(tmp_path):
    """R18 Mask R-CNN at 64 px, 3 steps, gated at AP 1.01: exit 1 and
    "passed": false; efficientdet-test at 128 px, 2 steps: exit 0. Both
    artifacts have the schema and name their JAX counterparts."""
    proc, out = _run_proof(tmp_path, "r18", [
        "--workdir", str(tmp_path / "r18"), "--device", "cpu", "--hard",
        "--add_mask", "--train_images", "6", "--val_images", "2",
        "--image_size", "64", "--steps", "3", "--batch_size", "2",
        "--min_ap", "1.01"], small_rois=True)
    assert proc.returncode == 1, proc.stderr
    assert "FAIL: AP" in proc.stderr
    assert set(out) == SCHEMA
    assert out["passed"] is False and out["trained_steps"] == 3
    assert out["jax_reference"] == "QUALITY_MASK_r05.json"
    assert out["device"] == "cpu" and out["compute_dtype"] == "float32"
    assert out["mask_iou"] is not None and np.isfinite(out["ap50"])
    assert out["ap50_exact_topk"] == out["ap50"]
    assert np.isfinite(out["train_loss"]["last10"])
    assert out["tree_hash"] == _hash(PKG)

    proc, out = _run_proof(tmp_path, "eff", [
        "--workdir", str(tmp_path / "eff"), "--device", "cpu",
        "--detector", "efficientdet-test", "--train_images", "8",
        "--val_images", "2", "--image_size", "128", "--steps", "2",
        "--batch_size", "4", "--min_ap", "0"])
    assert proc.returncode == 0, proc.stderr
    assert set(out) == SCHEMA
    assert out["passed"] is True and out["trained_steps"] == 2
    assert out["jax_reference"] == "QUALITY_EFFDET_r05.json"
    assert out["ap50_exact_topk"] is None and out["mask_iou"] is None
    assert out["kernel_launches"]["train"][
        "multilevel_roi_align_cuda"] == 0


def test_proof_refuses_video_domain_and_a_missing_gpu(tmp_path):
    """--video_domain with --add_mask is refused, as in JAX (the clips'
    gt is box-level); alone it renders the video-domain mix."""
    import torch
    from object_detection_tracking_tpu_torch.cli import quality_proof as TQ
    with pytest.raises(ValueError, match="--add_mask"):
        TQ.run(TQ.get_args(["--video_domain", "--add_mask", "--device",
                            "cpu", "--workdir", str(tmp_path)]))
    train, val = TQ.render_scenes(TQ.get_args(
        ["--video_domain", "--train_images", "6", "--val_images", "3"]))
    assert [s.name for s in train] == [
        "trv_000_0000", "trv_000_0003", "trv_000_0006", "tr00000",
        "tr00001", "tr00002"]
    assert [s.name for s in val] == ["va_000_0000", "va_000_0006",
                                     "va_001_0000"]
    assert all("masks" not in s.anno for s in train[:3] + val)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            TQ.run(TQ.get_args(["--workdir", str(tmp_path)]))


def _hash(root):
    from object_detection_tracking_tpu_torch.utils.source_hash import \
        quality_tree_hash
    return quality_tree_hash(root)


def test_tree_hash_moves_with_the_hashed_sources(tmp_path):
    """A byte more in a model, op, renderer, kernel, mask paste, train
    loop, video CLI or proof source moves the hash; a build product does
    not."""
    copy = tmp_path / "pkg"
    shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns(
        "build", "__pycache__"))
    base = _hash(str(copy))
    assert base == _hash(PKG) and re.fullmatch(r"[0-9a-f]{16}", base)
    for rel, moves in [("ops/nms.py", True), ("csrc/roi_align.cu", True),
                       ("data/synthetic_np.py", True),
                       ("models/faster_rcnn.py", True),
                       ("utils/masks.py", True), ("cli/main.py", True),
                       ("cli/quality_proof.py", True), ("params.py", True),
                       ("runtime/__init__.py", True),
                       ("cli/obj_detect_tracking.py", True),
                       ("cli/track_quality_proof.py", True),
                       ("evaluation_mot.py", True),
                       ("tracking/tmot/multitracker.py", True)]:
        path = copy / rel
        text = path.read_bytes()
        path.write_bytes(text + b"\n")
        assert (_hash(str(copy)) != base) == moves, rel
        path.write_bytes(text)
        assert _hash(str(copy)) == base
    (copy / "ops" / "x.so").write_bytes(b"\0")
    assert _hash(str(copy)) == base


ARTIFACTS = {
    "TORCH_QUALITY_R18.json": dict(
        jax="QUALITY_r05.json", min_ap=0.8, steps=5000, images=800,
        hard=True, mask=None),
    "TORCH_QUALITY_MASK.json": dict(
        jax="QUALITY_MASK_r05.json", min_ap=0.8, steps=1500, images=400,
        hard=True, mask=0.6),
    "TORCH_QUALITY_EFFDET.json": dict(
        jax="QUALITY_EFFDET_r05.json", min_ap=0.5, steps=1500, images=400,
        hard=False, mask=None),
}


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_committed_artifact_records_a_passing_card_run(name):
    """Each committed artifact records a passing run at its JAX
    counterpart's gates, step count and scenes, on an NVIDIA card with its
    power limit, in float32 with TF32 off. Whether its tree_hash is the
    tree's own is printed, not asserted: the port's trees move with every
    slice (ROADMAP's freshness rule)."""
    want = ARTIFACTS[name]
    with open(os.path.join(ROOT, name)) as f:
        out = json.load(f)
    assert set(out) == SCHEMA
    assert out["passed"] is True
    assert out["jax_reference"] == want["jax"]
    assert out["min_ap"] == want["min_ap"] and out["ap50"] >= want["min_ap"]
    assert out["min_mask_iou"] == want["mask"]
    if want["mask"] is not None:
        assert out["mask_iou"] >= want["mask"]
    assert out["trained_steps"] == want["steps"]
    assert out["train_images"] == want["images"]
    assert (out["val_images"], out["image_size"]) == (64, 160)
    assert out["hard"] is want["hard"] and out["video_domain"] is False
    assert re.fullmatch(r"NVIDIA .+, \d+(\.\d+)? W", out["device"]), \
        out["device"]
    assert out["compute_dtype"] == "float32" and out["tf32"] is False
    assert re.fullmatch(r"[0-9a-f]{16}", out["tree_hash"])
    fresh = out["tree_hash"] == _hash(PKG)
    print(f"{name}: tree_hash {out['tree_hash']} "
          f"{'fresh' if fresh else 'stale (the hashed trees moved since)'}")
