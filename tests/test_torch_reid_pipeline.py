"""The port's ReID CLIs (cli/single_video_reid.py, multi_video_reid.py,
reid_query.py) against the JAX package's on the same inputs: mp4 files
written with cv2 (160x160, 40 frames of textured boxes), MOT track files,
identical KRTD cameras, and ``.pth`` checkpoints of the port's seeded
osnet_x0_25 (Person) and resnet18 (Vehicle), chosen through the CLIs'
model-name flags. The port runs with ``--device cpu`` (float32); the JAX
CLIs' extractors are built in float32 too, and one extractor is kept per
checkpoint so that JAX compiles each net once. The outputs (MOT files,
printed lines, the printed distance matrix) must be equal.

The crops are resized, where the port keeps cv2's geometry but not its
uint8 rounding (ROADMAP C13), so the single-video test also asserts that
no candidate distance lies within 1% of ``--reject_dist_thres``: equal
merges are then not the luck of a C13-sized difference."""

import json
import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from object_detection_tracking_tpu.cli import multi_video_reid as jmulti
from object_detection_tracking_tpu.cli import reid_query as jquery
from object_detection_tracking_tpu.cli import single_video_reid as jsingle
from object_detection_tracking_tpu.models import reid as jreid
from object_detection_tracking_tpu.models.reid import extractor as jx
from object_detection_tracking_tpu.reid import single_video as jsv
from object_detection_tracking_tpu_torch.cli import multi_video_reid as tmulti
from object_detection_tracking_tpu_torch.cli import reid_query as tquery
from object_detection_tracking_tpu_torch.cli import \
    single_video_reid as tsingle
from object_detection_tracking_tpu_torch.reid import single_video as tsv
from torch_port_common import reid_net

HW, N_FRAMES = 160, 40
MODELS = {"Person": "osnet_x0_25", "Vehicle": "resnet18"}
# the relinking threshold (unsquared euclidean): with these weights the
# Person query's candidates score ~0.06 (its own object) and ~0.49, the
# Vehicle query's ~0.49 (its own object) and ~2.8, so the Person pair
# merges and the Vehicle pair does not
REJECT = 0.3
# (object, first frame, last frame, x0, y0, w, h): 2 px a frame to the right
OBJECTS = {"A": (0, 39, 10, 20, 24, 48), "B": (20, 39, 20, 64, 24, 48),
           "C": (0, 39, 4, 116, 48, 24), "D": (18, 39, 46, 96, 48, 24)}
# track id -> (class, object, first frame, last frame): A and C each lose
# their id once (1 -> 2, 5 -> 6); B and D start beside their ends
TRACKS = {1: ("Person", "A", 0, 17), 2: ("Person", "A", 20, 39),
          3: ("Person", "B", 20, 39), 5: ("Vehicle", "C", 0, 15),
          6: ("Vehicle", "C", 18, 39), 7: ("Vehicle", "D", 18, 39)}
KRTD = ("1000 0 80\n0 1000 80\n0 0 1\n\n1 0 0\n0 1 0\n0 0 1\n\n"
        "0 0 5\n\n0\n")


def _box(obj, frame):
    _, _, x0, y0, w, h = OBJECTS[obj]
    return x0 + 2 * frame, y0, w, h


def _write_video(path, textures):
    rng = np.random.RandomState(7)
    background = rng.randint(60, 120, (HW, HW, 3)).astype(np.uint8)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0,
                             (HW, HW))
    for f in range(N_FRAMES):
        im = background.copy()
        for obj, (first, last, *_) in OBJECTS.items():
            if first <= f <= last:
                x, y, w, h = _box(obj, f)
                im[y:y + h, x:x + w] = textures[obj][:, :min(w, HW - x)]
        writer.write(im)
    writer.release()


def _write_tracks(path, cls, id_offset=0, split=True):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows = []
    for tid, (c, obj, first, last) in TRACKS.items():
        if c != cls:
            continue
        if not split:   # one track per object, its whole life
            if obj in {o for t, (_, o, _, _) in TRACKS.items() if t < tid}:
                continue
            first, last = OBJECTS[obj][:2]
        for f in range(first, last + 1):
            rows.append((f, tid + id_offset, *_box(obj, f)))
    with open(path, "w") as fw:
        for r in sorted(rows):
            fw.write("%d,%d,%.2f,%.2f,%.2f,%.2f,1,-1,-1,-1\n" % r)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("reid_cli"))
    rng = np.random.RandomState(3)
    textures = {obj: rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
                for obj, (*_, w, h) in OBJECTS.items()}
    for name in ("v1", "cam1", "cam2"):
        _write_video(os.path.join(d, f"{name}.mp4"), textures)
    with open(os.path.join(d, "videos.lst"), "w") as f:
        f.write("v1.mp4\n")
    for cls in MODELS:
        _write_tracks(os.path.join(d, "tracks", "v1", cls, "v1.txt"), cls)
        for cam, offset in (("cam1", 0), ("cam2", 10)):
            _write_tracks(os.path.join(d, "tracks", cam, cls, f"{cam}.txt"),
                          cls, offset, split=False)
    for cam in ("cam1", "cam2"):
        with open(os.path.join(d, f"{cam}.krtd"), "w") as f:
            f.write(KRTD)
    with open(os.path.join(d, "cameras.json"), "w") as f:
        json.dump({"reference_camera": "cam1", "videos": {
            cam: {"video": f"{cam}.mp4", "camera_file": f"{cam}.krtd",
                  "frame_offset": 0} for cam in ("cam1", "cam2")}}, f)
    models = {}
    for cls, name in MODELS.items():
        models[cls] = os.path.join(d, f"{name}.pth")
        torch.save(reid_net(name, seed=5, size=(256, 128)).state_dict(),
                   models[cls])
    # the query images, at 256x128 (no resize): the objects' textures
    os.makedirs(os.path.join(d, "gallery"))
    for i, obj in enumerate("ABAB"):
        im = cv2.resize(textures[obj], (128, 256))
        im = np.roll(im, 3 * i, axis=1)
        cv2.imwrite(os.path.join(d, "gallery", f"g_{i}.png"), im)
    cv2.imwrite(os.path.join(d, "query.png"),
                cv2.resize(textures["A"], (128, 256)))
    return d, models


@pytest.fixture(scope="module")
def jax_extractors():
    """One float32 JAX extractor per (name, checkpoint); max_batch 8 cuts
    the padding (each call pads to it) without changing a feature."""
    cache = {}

    def make(name, path, **_):
        if (name, path) not in cache:
            cache[name, path] = jx.FeatureExtractor(
                name, path, max_batch=8, compute_dtype="float32")
        return cache[name, path]
    return make


def _read(path):
    with open(path) as f:
        return f.read()


def _printed(out):
    """reid_query's printout: (the lines before the matrix, the matrix)."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("[["))
    nums = " ".join(lines[start:]).replace("[", " ").replace("]", " ")
    return lines[:start], np.array(nums.split(), np.float64).reshape(5, 5)


def _model_flags(models):
    return ["--person_reid_model", models["Person"], "--vehicle_reid_model",
            models["Vehicle"], "--p_reid_model_name", MODELS["Person"],
            "--v_reid_model_name", MODELS["Vehicle"]]


def test_single_video_reid_matches_jax(inputs, jax_extractors, monkeypatch,
                                       capsys):
    d, models = inputs
    monkeypatch.setattr(jsingle, "FeatureExtractor", jax_extractors)
    scored = {}
    for pkg, mod in (("jax", jsv), ("port", tsv)):
        def record(candidates, *a, _f=mod.compute_candidate_distances,
                   _pkg=pkg, **k):
            out = _f(candidates, *a, **k)
            scored.setdefault(_pkg, []).append(
                {q: [e[:1] + e[-1:] for e in v] for q, v in out.items()})
            return out
        monkeypatch.setattr(mod, "compute_candidate_distances", record)
    out = {}
    for pkg, cli, extra in (("jax", jsingle, []),
                            ("port", tsingle, ["--device", "cpu"])):
        cli.main(["--video_dir", d, "--video_lst_file",
                  os.path.join(d, "videos.lst"), "--track_dir",
                  os.path.join(d, "tracks"), "--out_dir",
                  os.path.join(d, f"single_{pkg}"), "--feature_box_gap", "4",
                  "--reject_dist_thres", str(REJECT), *_model_flags(models),
                  *extra])
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["jax"] == "v1/Person: 2 tracks\n" \
                                        "v1/Vehicle: 3 tracks\n"
    for cls in MODELS:
        path = os.path.join("v1", cls, "v1.txt")
        got = _read(os.path.join(d, "single_port", path))
        assert got == _read(os.path.join(d, "single_jax", path))
        ids = {int(ln.split(",")[1]) for ln in got.splitlines()}
        assert ids == ({1, 3} if cls == "Person" else {5, 6, 7})
    # both classes scored two candidates; none near the threshold
    dists = [e[1] for run in scored["jax"] + scored["port"]
             for v in run.values() for e in v]
    assert len(dists) == 8
    assert all(abs(x - REJECT) > 0.01 * REJECT for x in dists), dists
    for ref, got in zip(scored["jax"], scored["port"]):
        assert ref.keys() == got.keys()
        for q in ref:
            assert [e[0] for e in ref[q]] == [e[0] for e in got[q]]


def test_multi_video_reid_matches_jax(inputs, jax_extractors, monkeypatch,
                                      capsys):
    d, models = inputs
    monkeypatch.setattr(jmulti, "FeatureExtractor", jax_extractors)
    out = {}
    for pkg, cli, extra in (("jax", jmulti, []),
                            ("port", tmulti, ["--device", "cpu"])):
        cli.main(["--camera_config", os.path.join(d, "cameras.json"),
                  "--video_dir", d, "--track_dir", os.path.join(d, "tracks"),
                  "--out_dir", os.path.join(d, f"multi_{pkg}"),
                  "--feature_box_gap", "4", *_model_flags(models), *extra])
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    for cam in ("cam1", "cam2"):
        for cls in MODELS:
            path = os.path.join(cam, cls, f"{cam}.txt")
            got = _read(os.path.join(d, "multi_port", path))
            assert got == _read(os.path.join(d, "multi_jax", path))
            rows = [ln.split(",") for ln in got.splitlines()]
            # every track's global id is its copy's in the other camera
            gids = {int(r[1]) % 10: int(r[7]) for r in rows}
            assert sorted(gids.values()) == [1, 2], gids


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_reid_query_matches_jax(inputs, jax_extractors, monkeypatch, capsys,
                                metric):
    d, models = inputs
    monkeypatch.setattr(jreid, "FeatureExtractor", jax_extractors)
    argv = [os.path.join(d, "query.png"), os.path.join(d, "gallery", "g_"),
            "--person_reid_model", models["Person"], "--p_model_name",
            MODELS["Person"], "--metric", metric]
    with np.printoptions():
        ref = jquery.main(argv)
        ref_out = capsys.readouterr().out
        got = tquery.main(argv + ["--device", "cpu"])
        got_out = capsys.readouterr().out
    assert got.shape == ref.shape == (5, 5)
    # the printed lines equal; the printed matrix equal to its last digit
    # (1e-3; a -0. against a 0. on the cosine diagonal pads the columns)
    got_lines, got_mat = _printed(got_out)
    ref_lines, ref_mat = _printed(ref_out)
    assert got_lines == ref_lines
    np.testing.assert_allclose(got_mat, ref_mat, rtol=0, atol=1.001e-3)
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def test_pyav_loader_flag_raises_naming_a12(inputs):
    """``--use_lijun_video_loader`` asks for the PyAV reader (JAX: "pyav"),
    which the port has not ported yet."""
    d, models = inputs
    with pytest.raises(NotImplementedError, match="A12"):
        tsingle.main(["--video_dir", d, "--video_lst_file",
                      os.path.join(d, "videos.lst"), "--track_dir",
                      os.path.join(d, "tracks"), "--out_dir",
                      os.path.join(d, "single_pyav"),
                      "--use_lijun_video_loader", "--device", "cpu",
                      *_model_flags(models)])
