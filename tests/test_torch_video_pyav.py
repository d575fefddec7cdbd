"""The port's PyAV reader (data/video.py ``PyAVReader``, ``open_video``)
against the JAX package's, with the stubbed ``av`` of
tests/test_video_pyav.py (``_fake_av``: frames carry their pts in decode
order, seek lands on the keyframe before the target, a broken index
decodes nothing): the same reads, fills, reorders and seeks; the same
reader or error from ``open_video`` for every decoder, extension and
PyAV presence. Then ``obj_detect_tracking --use_lijun_video_loader`` on a
stubbed container of moving rectangles (decode order shuffled, one frame
missing) gives the JAX CLI's MOT files, R18 partial-COCO, float32, BGR.
"""

import dataclasses
import os
import sys
import types
from fractions import Fraction

import numpy as np
import pytest

jax = pytest.importorskip("jax")
cv2 = pytest.importorskip("cv2")

from object_detection_tracking_tpu.cli import obj_detect_tracking as jcli  # noqa: E402
from object_detection_tracking_tpu.class_ids import coco_obj_to_actev_obj  # noqa: E402
from object_detection_tracking_tpu.data import video as jvideo  # noqa: E402
from object_detection_tracking_tpu.models import get_model as jax_model  # noqa: E402
from object_detection_tracking_tpu.runtime import DetectionRunner  # noqa: E402
from object_detection_tracking_tpu_torch.cli import obj_detect_tracking as tcli  # noqa: E402
from object_detection_tracking_tpu_torch.data import video as tvideo  # noqa: E402
from object_detection_tracking_tpu_torch.params import save_npz_tree  # noqa: E402
from tests.test_video_pyav import _fake_av  # noqa: E402
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import option_tree  # noqa: E402

H, W = 64, 96


# (pts in decode order, _fake_av options, the script of calls)
SCENARIOS = {
    "reorder": ([0, 2, 1, 4, 3, 5, 7, 6, 8, 9], {}, [("read", 20)]),
    "fix_missing": ([0, 1, 4, 5], {"num_frames": 6}, [("read", 10)]),
    "leading_gap": ([2, 3, 4], {}, [("read", 10)]),
    "duplicate_pts": ([0, 1, 1, 2, 3], {}, [("read", 10)]),
    "grab_then_read": ([0, 2, 1, 4, 3, 6, 5, 7], {},
                       [("grab", 3), ("read", 2), ("grab", 1), ("read", 9)]),
    "seek": (list(range(30)), {}, [("seek", 17, {}), ("read", 3),
                                   ("seek", 4, {}), ("read", 2),
                                   ("seek", 0, {}), ("read", 2)]),
    "seek_backstep": (list(range(30)), {"fail_seek_above": 15},
                      [("seek", 20, {"retry": 5, "retry_step": 6}),
                       ("read", 3)]),
    "seek_exhausted": (list(range(30)), {"fail_seek_above": -1},
                       [("seek", 20, {"retry": 2, "retry_step": 1})]),
    "seek_into_gap": (list(range(10)) + list(range(15, 30)),
                      {"num_frames": 30},
                      [("seek", 12, {"retry_step": 3}), ("read", 4),
                       ("seek", 8, {"retry_step": 3}), ("read", 4)]),
}


def run_script(module, monkeypatch, pts, opts, script):
    """The readings of ``module``'s PyAVReader through ``script``: per
    call, what it returned (pixel values read, grab flags) or the error it
    raised, and the reader's position after it."""
    monkeypatch.setitem(sys.modules, "av", _fake_av(pts, **opts))
    r = module.PyAVReader("fake.avi")
    log = [("meta", r.num_frames, r.fps)]
    for op, n, *kw in script:
        try:
            if op == "read":
                out = []
                for _ in range(n):
                    ok, frame = r.read()
                    out.append(int(frame[0, 0, 0]) if ok else None)
            elif op == "grab":
                out = [r.grab() for _ in range(n)]
            else:
                out = r.seek(n, **kw[0])
        except RuntimeError as e:
            out = ("RuntimeError", str(e))
        log.append((op, out, r.next_idx))
    return log


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pyav_reader_matches_jax(name, monkeypatch):
    pts, opts, script = SCENARIOS[name]
    ref = run_script(jvideo, monkeypatch, pts, opts, script)
    got = run_script(tvideo, monkeypatch, pts, opts, script)
    assert got == ref
    assert any(op == "read" and any(v is not None for v in out)
               for op, out, _ in ref[1:]) or name == "seek_exhausted"


@pytest.mark.parametrize("has_av", [True, False])
@pytest.mark.parametrize("path", ["clip.avi", "CLIP.AVI", "clip.mp4"])
@pytest.mark.parametrize("decoder", ["auto", "cv2", "pyav", "other"])
def test_open_video_dispatches_as_jax(tmp_path, monkeypatch, has_av, path,
                                      decoder):
    """The reader ``open_video`` picks (or the error it raises), for a
    file that is not there: cv2 fails to open it, the stub opens
    anything."""
    if has_av:
        monkeypatch.setitem(sys.modules, "av", _fake_av(list(range(4))))
    path = str(tmp_path / path)
    out = []
    for module in (jvideo, tvideo):
        monkeypatch.setattr(module, "_HAS_AV", has_av)
        try:
            out.append(type(module.open_video(path, decoder)).__name__)
        except (IOError, RuntimeError) as e:
            out.append((type(e).__name__, str(e)))
    assert out[1] == out[0]
    if has_av and decoder == "auto":
        assert out[0] == ("PyAVReader" if path.lower().endswith(".avi")
                          else ("OSError", f"cannot open video {path}"))


# --------------------------------------------------------------------------
# the CLI on a stubbed container


def frame_at(i):
    """Frame ``i`` of a clip of two moving rectangles (BGR uint8)."""
    base = np.tile(np.linspace(40, 90, W, dtype=np.uint8), (H, 1))
    frame = np.ascontiguousarray(np.stack([base] * 3, axis=-1))
    cv2.rectangle(frame, (5 + 2 * i, 8), (25 + 2 * i, 50), (200, 80, 60), -1)
    cv2.rectangle(frame, (70 - i, 20 + i // 2), (92 - i, 40 + i // 2),
                  (40, 160, 220), -1)
    return frame


def scene_av(pts_decode_order, num_frames):
    """An ``av`` stub whose frames are ``frame_at(pts)``."""
    av = types.ModuleType("av")

    class Frame:
        def __init__(self, pts):
            self.pts = pts

        def to_ndarray(self, format="bgr24"):
            return frame_at(self.pts)

    class Packet:
        def __init__(self, pts):
            self.frames = [Frame(pts)]

        def decode(self):
            return self.frames

    class Container:
        def __init__(self):
            stream = types.SimpleNamespace(
                frames=num_frames, average_rate=Fraction(30, 1),
                time_base=Fraction(1, 30))
            self.streams = types.SimpleNamespace(video=[stream])

        def demux(self, stream=None):
            return (Packet(p) for p in pts_decode_order)

        def seek(self, pts, stream=None, **kw):
            pass

        def close(self):
            pass

    av.open = lambda path: Container()
    return av


def read_mot(root):
    return {obj: np.loadtxt(os.path.join(root, "v", obj, "v.txt"),
                            delimiter=",", ndmin=2)
            for obj in ("Person", "Vehicle")}


@pytest.fixture(scope="module")
def run_both(tmp_path_factory):
    """Both CLIs with --use_lijun_video_loader on one stubbed clip: 24
    frames, decode order swapped in pairs, frame 7 missing (the reader
    fills it with frame 6); the port's run with --log_time_and_gpu."""
    tmp = tmp_path_factory.mktemp("pyav_cli")
    pts = [p for i in range(0, 24, 2) for p in (i + 1, i) if p != 7]
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "av", scene_av(pts, 24))
    for module in (jvideo, tvideo):
        mp.setattr(module, "_HAS_AV", True)
    mp.setattr(tcli, "PERF_INTERVAL", 0.05)
    (tmp / "list.txt").write_text("v.avi\n")
    argv = ["--video_dir", str(tmp), "--video_lst_file",
            str(tmp / "list.txt"), "--use_partial_classes", "--resnet18",
            "--short_edge_size", str(H), "--max_size", str(W),
            "--rpn_test_post_nms_topk", "32", "--frame_gap", "2",
            "--im_batch_size", "4", "--compute_dtype", "float32",
            "--get_tracking", "--min_confidence", "0.0",
            "--pixel_format", "bgr", "--use_lijun_video_loader"]
    try:
        jargs = jcli.get_args(argv + ["--tracking_dir", str(tmp / "jax")])
        cfg = dataclasses.replace(jcli.build_config(jargs),
                                  roi_align_impl="xla", rpn_topk_recall=1.0)
        tree = option_tree(cfg)      # the port's init, BN gammas x0.2
        save_npz_tree(str(tmp / "params.npz"), tree)
        n_jax = jcli.process_video(
            jargs, cfg, DetectionRunner(jax_model(cfg), tree),
            str(tmp / "v.avi"), cfg.classid2name,
            dict(coco_obj_to_actev_obj))
        tcli.main(argv + ["--tracking_dir", str(tmp / "torch"), "--device",
                          "cpu", "--model_path", str(tmp / "params.npz"),
                          "--log_time_and_gpu", "--save_util_log_to",
                          str(tmp / "util.json")])
    finally:
        mp.undo()
    return n_jax, read_mot(str(tmp / "jax")), read_mot(str(tmp / "torch")), tmp


def test_pyav_cli_mot_files_match_jax_cli(run_both):
    n_jax, ref, got, _ = run_both
    assert n_jax == 12
    assert sum(len(r) for r in ref.values()) > 0
    for obj in ref:
        assert got[obj].shape == ref[obj].shape, obj
        np.testing.assert_array_equal(got[obj][:, :2], ref[obj][:, :2])
        np.testing.assert_allclose(got[obj][:, 2:6], ref[obj][:, 2:6],
                                   atol=0.05, rtol=0)


def test_log_time_and_gpu_writes_jax_keys(run_both, tmp_path):
    """--save_util_log_to writes the JAX logger's series; the CPU device
    samples 0 device bytes, as JAX's logger does without memory stats."""
    import json
    from object_detection_tracking_tpu.runtime.profiler import \
        PerformanceLogger as JaxLogger
    with open(run_both[3] / "util.json") as f:
        got = json.load(f)
    ref = JaxLogger(interval=10.0)
    ref._sample()
    ref.save(str(tmp_path / "jax.json"))
    with open(tmp_path / "jax.json") as f:
        assert sorted(got) == sorted(json.load(f))
    assert len(got["time"]) >= 1 and set(got["device_bytes"]) == {0.0}
    assert all(len(v) == len(got["time"]) for v in got.values())
