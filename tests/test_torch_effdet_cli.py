"""The port's video CLI with ``--is_efficientdet`` against the JAX CLI, end
to end on the CPU: one cv2-written synthetic video of moving rectangles,
one set of params (the port's init calibrated on frames like the video's,
tests/torch_port_common.py effdet_params, saved with the JAX package's
save_npz and loaded by the port's --model_path), efficientdet-test with
partial COCO classes in float32.

The JAX side runs its own CLI path (get_args, build_config, its runner and
process_video) with ``roi_align_impl="xla"`` (the exact reference). Both
write MOT text; the rows must name the same frames and track ids, and the
boxes agree to 0.05 px (the files print two decimals). Frames go as BGR
(the jitted JAX forward rounds the fused I420 conversion differently from
its eager form; tests/test_torch_efficientdet.py covers I420).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from object_detection_tracking_tpu.cli import obj_detect_tracking as jcli  # noqa: E402
from object_detection_tracking_tpu.class_ids import coco_obj_to_actev_obj  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu.runtime import DetectionRunner  # noqa: E402
from object_detection_tracking_tpu.utils.weights import save_npz  # noqa: E402
from object_detection_tracking_tpu_torch.cli import obj_detect_tracking as tcli  # noqa: E402
from object_detection_tracking_tpu_torch.runtime import DetectionRunner as TRunner  # noqa: E402
from test_torch_cli import make_video, read_mot  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import effdet_params  # noqa: E402

ARGV = ["--is_efficientdet", "--efficientdet_modelname", "efficientdet-test",
        "--use_partial_classes", "--frame_gap", "2", "--im_batch_size", "4",
        "--compute_dtype", "float32", "--get_tracking",
        "--min_confidence", "0.0", "--pixel_format", "bgr"]


@pytest.fixture(scope="module")
def run_both(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("effdet_cli")
    vdir = tmp / "videos"
    vdir.mkdir()
    make_video(str(vdir / "v.mp4"))
    (tmp / "list.txt").write_text("v.mp4\n")
    argv = ["--video_dir", str(vdir), "--video_lst_file",
            str(tmp / "list.txt")] + ARGV
    jargs = jcli.get_args(argv + ["--tracking_dir", str(tmp / "jax")])
    cfg = dataclasses.replace(jcli.build_config(jargs), roi_align_impl="xla")
    # the CLI fits 64x96 frames into 128 px: 85 x 128 through the enqueuer
    calib = np.random.RandomState(3).randint(0, 255, (4, 85, 128, 3))
    _, params = effdet_params(cfg, calib.astype(np.uint8))
    save_npz(str(tmp / "params.npz"), params)
    model = jax_model(cfg, "efficientdet")
    n_jax = jcli.process_video(
        jargs, cfg, DetectionRunner(model, params), str(vdir / "v.mp4"),
        cfg.classid2name, dict(coco_obj_to_actev_obj))
    tcli.main(argv + ["--tracking_dir", str(tmp / "torch"), "--device", "cpu",
                      "--model_path", str(tmp / "params.npz")])
    return n_jax, read_mot(str(tmp / "jax")), read_mot(str(tmp / "torch")), \
        cfg


def test_effdet_config_follows_jax_cli():
    import torch
    base = ["--video_dir", ".", "--video_lst_file", "x"]
    for extra in ([], ["--use_partial_classes"],
                  ["--efficientdet_modelname", "efficientdet-d6",
                   "--efficientdet_max_detection_topk", "1000"]):
        argv = base + ["--is_efficientdet", "--compute_dtype",
                       "float32"] + extra
        ref = jcli.build_config(jcli.get_args(argv))
        got = tcli.build_config(tcli.get_args(argv), torch.device("cpu"))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_effdet_mot_files_match_jax_cli(run_both):
    n_jax, ref, got, _ = run_both
    assert n_jax == 12
    assert sum(len(r) for r in ref.values()) > 0
    for obj in ref:
        assert got[obj].shape == ref[obj].shape, obj
        np.testing.assert_array_equal(got[obj][:, :2], ref[obj][:, :2])
        np.testing.assert_allclose(got[obj][:, 2:6], ref[obj][:, 2:6],
                                   atol=0.05, rtol=0)


def test_effdet_runner_refuses_what_it_cannot_give(run_both):
    """EfficientDet outputs mean-pooled embeddings only (no
    ``fpn_box_feat``): --emb_agg_method max/spatial and --get_box_feat
    raise, as in the JAX runner."""
    import torch
    from object_detection_tracking_tpu_torch.config import DetectorConfig
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            params_from_jax)
    cfg = DetectorConfig(**dataclasses.asdict(run_both[3]))
    model = params_from_jax(init_params(cfg, 0, "efficientdet"),
                            get_model(cfg, "efficientdet"))
    imgs = np.zeros((1, 85, 128, 3), np.uint8)
    for kw in ({"emb_agg": "max"}, {"emb_agg": "spatial"},
               {"ship_full_feat": True}):
        with pytest.raises(ValueError, match="fpn_box_feat"):
            list(TRunner(model, **kw).run([(imgs, None)]))
    out, _ = next(TRunner(model).run([(imgs, None)]))
    assert set(out) == set(TRunner.FETCH_KEYS)
    assert out["pooled_box_feat"].shape == (1, 100, 32)
    assert torch.is_grad_enabled()
