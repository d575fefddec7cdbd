"""The port's video detect-and-track CLI against the JAX CLI, end to end on
the CPU: one cv2-written synthetic video of moving rectangles, one set of
params (JAX init_params, saved with the JAX package's save_npz and loaded
by the port's --model_path), R18 partial-COCO with the Mask R-CNN head
(--add_mask) in float32.

The JAX side runs its own CLI path (get_args, build_config, its runner and
process_video) with roi_align_impl="xla" (the exact reference) and exact
top-k. Both write MOT text; the rows must name the same frames and track
ids, and the boxes agree to 0.05 px (float32 sums ordered differently move
a box by ~1e-4 px; the files print two decimals). Both write per-frame
JSON with RLE segmentations; decoded, each mask agrees with the JAX one on
at least 99% of the frame's pixels (a mask value near 0.5 may threshold
the other way). The same video and params go through both CLIs once more
with ``--tracker tmot``, under the same rule for the MOT files. Frames go
as BGR: the
jitted JAX forward rounds the fused I420 conversion differently from its
eager form (test_torch_forward.py covers I420).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from object_detection_tracking_tpu.cli import obj_detect_tracking as jcli  # noqa: E402
from object_detection_tracking_tpu.class_ids import coco_obj_to_actev_obj  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu.runtime import DetectionRunner  # noqa: E402
from object_detection_tracking_tpu.utils.weights import save_npz  # noqa: E402
from object_detection_tracking_tpu_torch.cli import obj_detect_tracking as tcli  # noqa: E402
from object_detection_tracking_tpu_torch.utils.masks import rle_decode  # noqa: E402
from torch_port_common import jax_params  # noqa: E402

H, W = 64, 96


def make_video(path, n_frames=24):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
    base = np.tile(np.linspace(40, 90, W, dtype=np.uint8), (H, 1))
    base = np.stack([base] * 3, axis=-1)
    for i in range(n_frames):
        frame = base.copy()
        cv2.rectangle(frame, (5 + 2 * i, 8), (25 + 2 * i, 50), (200, 80, 60),
                      -1)
        cv2.rectangle(frame, (70 - i, 20 + i // 2), (92 - i, 40 + i // 2),
                      (40, 160, 220), -1)
        vw.write(frame)
    vw.release()


def read_mot(root):
    out = {}
    for obj in ("Person", "Vehicle"):
        path = os.path.join(root, "v", obj, "v.txt")
        rows = np.loadtxt(path, delimiter=",", ndmin=2)
        out[obj] = rows
    return out


@pytest.fixture(scope="module")
def run_both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    vdir = tmp / "videos"
    vdir.mkdir()
    make_video(str(vdir / "v.mp4"))
    (tmp / "list.txt").write_text("v.mp4\n")
    argv = ["--video_dir", str(vdir), "--video_lst_file",
            str(tmp / "list.txt"), "--use_partial_classes", "--resnet18",
            "--short_edge_size", str(H), "--max_size", str(W),
            "--rpn_test_post_nms_topk", "32", "--frame_gap", "2",
            "--im_batch_size", "4", "--compute_dtype", "float32",
            "--get_tracking", "--min_confidence", "0.0",
            "--pixel_format", "bgr", "--add_mask"]

    jargs = jcli.get_args(argv + ["--tracking_dir", str(tmp / "jax"),
                                  "--out_dir", str(tmp / "jaxjson")])
    cfg = dataclasses.replace(jcli.build_config(jargs), roi_align_impl="xla",
                              rpn_topk_recall=1.0)
    model = jax_model(cfg)
    params = jax_params(model)
    save_npz(str(tmp / "params.npz"), params)
    runner = DetectionRunner(model, params)
    n_jax = jcli.process_video(
        jargs, cfg, runner, str(vdir / "v.mp4"), cfg.classid2name,
        dict(coco_obj_to_actev_obj))

    tcli.main(argv + ["--tracking_dir", str(tmp / "torch"), "--device", "cpu",
                      "--model_path", str(tmp / "params.npz"),
                      "--out_dir", str(tmp / "json")])

    # the TMOT pass: same video, params and runner, --tracker tmot
    jargs = jcli.get_args(argv + ["--tracker", "tmot", "--tracking_dir",
                                  str(tmp / "jax_tmot")])
    n_tmot = jcli.process_video(
        jargs, cfg, runner, str(vdir / "v.mp4"), cfg.classid2name,
        dict(coco_obj_to_actev_obj))
    assert n_tmot == n_jax
    tcli.main(argv + ["--tracker", "tmot", "--tracking_dir",
                      str(tmp / "torch_tmot"), "--device", "cpu",
                      "--model_path", str(tmp / "params.npz")])
    return n_jax, read_mot(str(tmp / "jax")), read_mot(str(tmp / "torch")), tmp


def test_mot_files_match_jax_cli(run_both):
    n_jax, ref, got, _ = run_both
    assert n_jax == 12
    assert sum(len(r) for r in ref.values()) > 0
    for obj in ref:
        assert got[obj].shape == ref[obj].shape, obj
        np.testing.assert_array_equal(got[obj][:, :2], ref[obj][:, :2])
        np.testing.assert_allclose(got[obj][:, 2:6], ref[obj][:, 2:6],
                                   atol=0.05, rtol=0)


def test_tmot_mot_files_match_jax_cli(run_both):
    """--tracker tmot through both CLIs: the same frames and track ids, the
    boxes (the matched detections' own) within 0.05 px."""
    tmp = run_both[3]
    ref, got = read_mot(str(tmp / "jax_tmot")), read_mot(str(tmp /
                                                            "torch_tmot"))
    assert sum(len(r) for r in ref.values()) > 0
    for obj in ref:
        assert got[obj].shape == ref[obj].shape, obj
        np.testing.assert_array_equal(got[obj][:, :2], ref[obj][:, :2])
        np.testing.assert_allclose(got[obj][:, 2:6], ref[obj][:, 2:6],
                                   atol=0.05, rtol=0)


def test_frame_json_written(run_both):
    tmp = run_both[3]
    files = sorted(os.listdir(tmp / "json" / "v"))
    assert files == sorted(f"{i}.json" for i in range(0, 24, 2))


def test_segmentation_matches_jax_cli(run_both):
    tmp = run_both[3]
    masked = 0
    for name in sorted(os.listdir(tmp / "jaxjson" / "v")):
        with open(tmp / "jaxjson" / "v" / name) as f:
            ref = json.load(f)
        with open(tmp / "json" / "v" / name) as f:
            got = json.load(f)
        assert len(got) == len(ref), name
        for g, r in zip(got, ref):
            assert g["category_id"] == r["category_id"]
            np.testing.assert_allclose(g["bbox"], r["bbox"], atol=0.05)
            assert g["segmentation"]["size"] == r["segmentation"]["size"] \
                == [H, W]
            gm = rle_decode(g["segmentation"])
            rm = rle_decode(r["segmentation"])
            assert (gm == rm).mean() >= 0.99, name
            masked += int(rm.any())
    assert masked > 0


def test_cli_refuses_unported_flags_and_missing_gpu(tmp_path):
    """The A12 flags raise; the five architecture options (ported) reach
    the configuration as JAX's build_config forwards them, and the
    small-object head, which no flag of this CLI turns on (as in JAX),
    builds once the configuration asks for it (A8b, ported)."""
    base = ["--video_dir", str(tmp_path), "--video_lst_file", "x"]
    for flag in ("--use_lijun_video_loader", "--log_time_and_gpu"):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            tcli.get_args(base + [flag])
    toggles = ["--use_deformable", "--use_gn", "--add_relation_nn",
               "--use_att_frcnn_head", "--use_conv_frcnn_head"]
    argv = base + toggles
    got = tcli.build_config(tcli.get_args(argv), torch.device("cpu"))
    ref = jcli.build_config(jcli.get_args(argv + ["--compute_dtype",
                                                  "float32"]))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.use_deformable and got.add_relation_nn
    from object_detection_tracking_tpu_torch.models import get_model
    so = get_model(dataclasses.replace(got, use_small_object_head=True,
                                       use_conv_frcnn_head=False))
    assert len(so.small_objects) == len(so.so_ids) == 3   # ActEV's SO names
    assert not hasattr(tcli.get_args(base), "use_small_object_head")
    args = tcli.get_args(base + ["--tracker", "tmot"])
    assert args.tracker == "tmot"
    assert (args.track_max_second_lost, args.emb_max_dist) == (4.0, 0.7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tcli.resolve_device("cuda")
