"""Weights trained by the port's train CLI, written as the JAX package's
native .npz (params.save_npz_tree), loaded by the JAX package's
load_weights bit for bit, and run by the JAX inference forward to the
port's outputs on the same weights (``compare_forward``'s tolerances)."""

import os

import numpy as np

from object_detection_tracking_tpu.config import DetectorConfig
from object_detection_tracking_tpu.models import get_model as jax_model
from object_detection_tracking_tpu.utils.weights import load_weights
from object_detection_tracking_tpu_torch.cli import main as M
from object_detection_tracking_tpu_torch.params import (load_npz_tree,
                                                        params_to_jax,
                                                        save_npz_tree)
from test_torch_train_cli import H, W, _synthetic_args
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import compare_forward, flat, jax_params, train_batch


def _jax_cfg(**kw):
    """The JAX inference config of SMALL's model."""
    return DetectorConfig.from_version(
        2, resnet_depth=18, short_edge_size=H, max_size=W,
        rpn_test_post_nms_topk=32, result_per_im=8, compute_dtype="float32",
        rpn_topk_recall=1.0, roi_align_impl="xla", **kw)


def test_trained_npz_loads_into_jax_with_the_same_forward(tmp_path):
    """Weights in by ``--load_from`` (the JAX init with the 0.2 BN-gamma
    scaling, so that detections exist), two steps, and the final.npz read
    by the JAX package's load_weights: its inference forward equals the
    port's on those weights (compare_forward's tolerances)."""
    cfg = _jax_cfg()
    init = str(tmp_path / "init.npz")
    save_npz_tree(init, jax_params(jax_model(cfg)))
    out, args = _synthetic_args(tmp_path, "--load_from", init, "--num_step",
                                "2", "--freeze", "0")
    res = M.mode_train(args)
    final = os.path.join(out, "odt", "final.npz")
    assert not np.array_equal(flat(load_npz_tree(final))["fastrcnn/fc7/W"],
                              flat(load_npz_tree(init))["fastrcnn/fc7/W"])
    params = load_weights(final, jax_model(cfg))
    for k, v in flat(params_to_jax(res["trainer"].model)).items():
        np.testing.assert_array_equal(np.asarray(flat(params)[k]), v,
                                      err_msg=k)
    compare_forward(cfg, params, train_batch(h=H, w=W, seed=5)[0])
