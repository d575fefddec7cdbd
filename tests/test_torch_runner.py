"""The port's DetectionRunner keeps the JAX runner's contract: FETCH_KEYS,
in-order (host dict, meta) with a depth-2 pipeline, emb_agg average / max
/ spatial, and embeddings rounded through bf16 (runtime/runner.py:30,
133-153, 202-287 of the JAX package)."""

import numpy as np
import pytest
import torch

from object_detection_tracking_tpu_torch.runtime import DetectionRunner
from torch_port_common import one_torch_thread  # noqa: E402,F401


class FakeModel:
    """Deterministic 'detector' encoding each frame's mean in its outputs."""

    device = torch.device("cpu")

    def __call__(self, images):
        b = images.shape[0]
        r, c = 4, 8
        val = images.reshape(b, -1).float().mean(dim=1)
        grid = torch.arange(49, dtype=torch.float32).reshape(1, 1, 7, 7, 1)
        full = grid.expand(b, r, 7, 7, c) + val[:, None, None, None, None] \
            + torch.arange(c) / 3.0
        return {
            "final_boxes": val[:, None, None].expand(b, r, 4).clone(),
            "final_labels": torch.ones((b, r), dtype=torch.int32),
            "final_probs": (val[:, None] / 255.0).expand(b, r).clone(),
            "final_valid": torch.ones((b, r), dtype=torch.bool),
            "pooled_box_feat": full.mean(dim=(2, 3)),
            "fpn_box_feat": full,
        }


def batches(n=5, b=2):
    rng = np.random.RandomState(0)
    for i in range(n):
        yield rng.randint(0, 256, (b, 6, 8, 3)).astype(np.uint8), i


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float() \
        .numpy()


def test_runner_order_keys_and_bf16_embeddings():
    runner = DetectionRunner(FakeModel(), depth=2)
    got = list(runner.run(batches()))
    assert [m for _, m in got] == list(range(5))
    for (out, _), (imgs, _) in zip(got, batches()):
        assert set(out) == set(DetectionRunner.FETCH_KEYS)
        mean = imgs.reshape(2, -1).mean(1)
        np.testing.assert_allclose(out["final_boxes"][:, 0, 0], mean,
                                   rtol=1e-6)
        assert out["final_labels"].dtype == np.int32
        assert out["final_valid"].dtype == bool
        pooled = FakeModel()(torch.from_numpy(imgs))["pooled_box_feat"]
        assert out["pooled_box_feat"].dtype == np.float32
        np.testing.assert_array_equal(out["pooled_box_feat"], bf16(pooled))


@pytest.mark.parametrize("agg,dim", [("avg", 8), ("max", 8), ("spatial", 49)])
def test_runner_emb_agg_modes(agg, dim):
    runner = DetectionRunner(FakeModel(), emb_agg=agg)
    (out, _), = list(runner.run(batches(1)))
    imgs = next(batches(1))[0]
    full = FakeModel()(torch.from_numpy(imgs))["fpn_box_feat"]
    ref = {"avg": full.mean(dim=(2, 3)), "max": full.amax(dim=(2, 3)),
           "spatial": full.mean(dim=-1).reshape(2, 4, -1)}[agg]
    assert out["pooled_box_feat"].shape == (2, 4, dim)
    np.testing.assert_array_equal(out["pooled_box_feat"], bf16(ref))


def test_runner_ship_full_feat_and_bad_agg():
    runner = DetectionRunner(FakeModel(), ship_full_feat=True, depth=1)
    (out, _), = list(runner.run(batches(1)))
    assert out["fpn_box_feat"].shape == (2, 4, 7, 7, 8)
    with pytest.raises(ValueError):
        DetectionRunner(FakeModel(), emb_agg="median")


def test_runner_empty_iterator():
    assert list(DetectionRunner(FakeModel()).run(iter([]))) == []
