"""The port's ReID extractor (models/reid/extractor.py) against the JAX
package's: ``FeatureExtractor`` on crops already at ``image_size`` (where
both see the same pixels; JAX pads each chunk to ``max_batch``, the port
does not), the crop preprocess against ``cv2.resize`` (ROADMAP C13: the
port resizes in float and keeps the float), the checkpoint loader, the
weight bridge back from the JAX package's flat dict, the distance matrix,
and the registry's names."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from object_detection_tracking_tpu.models.reid import extractor as jx
from object_detection_tracking_tpu_torch.models.reid import extractor as tx
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import close, reid_net

SIZE = (64, 32)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("reid")
    out = {}
    for name in ("osnet_x0_25", "resnet50_fc512"):
        out[name] = str(d / f"{name}.pth")
        torch.save(reid_net(name, seed=3, size=SIZE).state_dict(),
                   out[name])
    return out


def _crops(rng, n, sizes):
    return [rng.randint(0, 256, (*sizes[i % len(sizes)], 3)).astype(np.uint8)
            for i in range(n)]


@pytest.mark.parametrize("name", ["osnet_x0_25", "resnet50_fc512"])
def test_extractor_matches_jax_on_crops_at_size(name, checkpoints):
    crops = _crops(np.random.RandomState(0), 7, [SIZE])
    ref = jx.FeatureExtractor(name, checkpoints[name], image_size=SIZE,
                              max_batch=3, compute_dtype="float32")(crops)
    port = tx.FeatureExtractor(name, checkpoints[name], image_size=SIZE,
                               max_batch=3, compute_dtype="float32",
                               device="cpu")
    got = port(crops)
    assert got.dtype == np.float32 and got.shape == ref.shape == (7, 512)
    close(got, ref, rel=1e-4)
    # the chunking changes a sample's features by float32 rounding only
    # (the CPU's conv picks its algorithm by batch size)
    port.max_batch = 64
    close(port(crops[2:5]), got[2:5], rel=1e-5)
    assert port([]).shape == (0, 1)


def test_preprocess_within_c13_of_cv2(checkpoints):
    """Crops of 4-400 x 4-300 px, up and down to 256x128, and one at size:
    the port's float resize within 1.0 of cv2's uint8 one (0-255 scale),
    the crop at size equal."""
    rng = np.random.RandomState(1)
    crops = [rng.randint(0, 256, (rng.randint(4, 401), rng.randint(4, 301),
                                  3)).astype(np.uint8) for _ in range(40)]
    crops.append(rng.randint(0, 256, (256, 128, 3)).astype(np.uint8))
    path = checkpoints["osnet_x0_25"]
    ref = jx.FeatureExtractor("osnet_x0_25", path)._preprocess(crops)
    got = tx.FeatureExtractor("osnet_x0_25", path, compute_dtype="float32",
                              device="cpu").preprocess(crops).numpy()
    assert got.shape == ref.shape == (41, 256, 128, 3)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    d255 = np.abs(got - ref) * std * 255.0
    assert d255.max() <= 1.0, d255.max()
    assert d255.mean() <= 0.3, d255.mean()
    np.testing.assert_array_equal(got[-1], ref[-1])


def test_load_reid_state_dict_strips_module_and_drops_classifier(tmp_path):
    sd = {"module.conv1.weight": torch.randn(2, 3, 1, 1),
          "module.layer1.se_module.fc1.weight": torch.randn(4, 2),
          "module.fc.1.num_batches_tracked": torch.tensor(5),
          "module.classifier.weight": torch.randn(10, 4),
          "module.classifier.bias": torch.randn(10)}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": sd, "epoch": 3, "rank1": np.float64(0.5)},
               path)
    got = tx.load_reid_state_dict(path)
    ref = jx.load_torch_state_dict(path)
    assert set(got) == set(ref) == {"conv1.weight",
                                    "layer1.se_module.fc1.weight",
                                    "fc.1.num_batches_tracked"}
    for k, v in got.items():
        assert torch.equal(v, sd["module." + k])
    # a bare state dict loads as it is
    torch.save({"conv1.weight": sd["module.conv1.weight"]}, path)
    assert list(tx.load_reid_state_dict(path)) == ["conv1.weight"]


@pytest.mark.parametrize("name", ["osnet_x0_25", "resnet50_fc512"])
def test_state_dict_from_jax_round_trips_bit_for_bit(name, checkpoints,
                                                     tmp_path):
    """port state dict -> .pth -> JAX's flat dict -> the port's state dict
    again, and that one through JAX's loader to the same flat dict."""
    sd = tx.load_reid_state_dict(checkpoints[name])
    flat = jx.load_torch_state_dict(checkpoints[name])
    back = tx.state_dict_from_jax(flat)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    net = tx.build_reid_model(name)
    net.load_state_dict(back)
    path = str(tmp_path / "back.pth")
    torch.save(back, path)
    again = jx.load_torch_state_dict(path)
    assert set(again) == set(flat)
    for k, v in flat.items():
        assert again[k].dtype == v.dtype and again[k].shape == v.shape
        np.testing.assert_array_equal(again[k], v)
    if name.startswith("osnet"):   # depthwise [k, k, 1, C] kernels crossed
        assert any(v.shape[:3] == (3, 3, 1) for v in flat.values()
                   if v.ndim == 4)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_distance_matrix_matches_jax(metric):
    rng = np.random.RandomState(2)
    a = rng.randn(5, 16).astype(np.float32)
    b = rng.randn(7, 16).astype(np.float32)
    np.testing.assert_array_equal(tx.compute_distance_matrix(a, b, metric),
                                  jx.compute_distance_matrix(a, b, metric))
    with pytest.raises(ValueError):
        tx.compute_distance_matrix(a, b, "l1")


def test_registry_names(checkpoints, monkeypatch):
    """Every JAX registry name is ported or raises naming ROADMAP A11b; an
    unknown name raises ValueError as in JAX; a checkpoint is required; a
    CUDA request without a GPU raises."""
    assert set(tx.MODELS) | set(tx.NOT_PORTED) == set(jx.FORWARDS)
    assert not set(tx.MODELS) & set(tx.NOT_PORTED)
    assert tx.FIXED_IMAGE_SIZE == jx.FIXED_IMAGE_SIZE
    for name in tx.NOT_PORTED:
        with pytest.raises(NotImplementedError, match="A11b"):
            tx.FeatureExtractor(name, "x.pth", device="cpu")
    for mod in (tx, jx):
        with pytest.raises(ValueError, match="unknown reid model"):
            mod.FeatureExtractor("osnet_x9", "x.pth")
        with pytest.raises(ValueError, match="requires model_path"):
            mod.FeatureExtractor("osnet_x0_25")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tx.FeatureExtractor("osnet_x0_25", checkpoints["osnet_x0_25"])


def test_reid_nets_are_outside_the_quality_hash(tmp_path):
    """No quality proof runs a ReID net: a byte more in models/reid leaves
    the proofs' tree hash (utils/source_hash.py) as it is, and one in the
    detector's models/resnet.py still moves it."""
    import os
    import shutil

    import object_detection_tracking_tpu_torch as port
    from object_detection_tracking_tpu_torch.utils.source_hash import \
        quality_tree_hash
    copy = tmp_path / "pkg"
    shutil.copytree(os.path.dirname(port.__file__), copy,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    base = quality_tree_hash(str(copy))
    for rel, moves in (("models/reid/osnet.py", False),
                       ("models/resnet.py", True)):
        path = copy / rel
        text = path.read_bytes()
        path.write_bytes(text + b"\n")
        assert (quality_tree_hash(str(copy)) != base) == moves, rel
        path.write_bytes(text)
