"""Shared pieces of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py): small configurations, seeded params, the
float32 comparison rule."""

import numpy as np

from object_detection_tracking_tpu.config import DetectorConfig

H, W = 64, 96
SMALL = dict(short_edge_size=H, max_size=W, rpn_test_post_nms_topk=32,
             result_per_im=8, compute_dtype="float32", rpn_topk_recall=1.0,
             roi_align_impl="xla")
CONFIGS = {
    "r18": lambda: DetectorConfig(num_class=5, resnet_depth=18, **SMALL),
    "r50_partial_coco": lambda: DetectorConfig.coco_partial(
        resnet_depth=50, **SMALL),
    "r50_v4": lambda: DetectorConfig.from_version(
        4, num_class=5, resnet_depth=50, **SMALL),
}


def jax_params(jm, seed=0):
    """JAX init_params as numpy, with each residual branch's last BN gamma
    scaled by 0.2. Random ResNet weights otherwise grow activations to
    ~1e3 by p2, every RPN box decodes off the image, and no proposal
    survives: the comparison would only see empty outputs."""
    import jax
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    for gname, group in params["resnet"].items():
        if gname.startswith("group"):
            for blk in group.values():
                last = blk["conv3"] if "conv3" in blk else blk["conv2"]
                last["bn"]["gamma"] = last["bn"]["gamma"] * 0.2
    return params


def close(got, ref, rel=1e-4):
    """float32 agreement up to ``rel`` of the reference's largest
    magnitude (differently ordered sums round differently)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * max(np.abs(ref).max(), 1e-6))


def compare_forward(cfg, params, imgs):
    """The port's forward against the eager JAX forward on the same params
    and uint8 frames: valid slots and labels equal, boxes to 1e-3 px,
    probabilities to 1e-5, embeddings to 1e-4 of their largest magnitude,
    invalid slots 0. Returns (port outputs, JAX outputs) as numpy."""
    import torch

    from object_detection_tracking_tpu.models import get_model as jax_model
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import params_from_jax
    tm = params_from_jax(params, get_model(cfg))
    ref = {k: np.asarray(v)
           for k, v in jax_model(cfg).forward(params, imgs).items()}
    with torch.inference_mode():
        got = {k: v.numpy() for k, v in tm(torch.from_numpy(imgs)).items()}
    assert set(got) == set(ref)
    valid = ref["final_valid"]
    assert valid.any()
    np.testing.assert_array_equal(got["final_valid"], valid)
    np.testing.assert_array_equal(got["final_labels"], ref["final_labels"])
    np.testing.assert_allclose(got["final_boxes"], ref["final_boxes"],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["final_probs"], ref["final_probs"],
                               atol=1e-5, rtol=0)
    close(got["pooled_box_feat"], ref["pooled_box_feat"])
    close(got["fpn_box_feat"], ref["fpn_box_feat"])
    assert not got["fpn_box_feat"][~valid].any()
    return got, ref
