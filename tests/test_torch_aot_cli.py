"""``main.py pack`` of the port on the CPU with the flags of JAX's own pack
tests (tests/test_quality.py test_pack_mode_smoke and
test_pack_mode_f16_params, plus ``--device cpu``): the pack's files, its
closing line, and ``load_packed``'s ``fn`` against the port's live forward
on the pack's config and params.npz, bit for bit; with
``--pack_params_dtype float16`` against the f32 forward on the
float16-rounded weights (JAX's test: boxes within 0.5 px, labels equal;
the graph widens the float16 leaves exactly, so here they are also equal
bit for bit). The SMALL pack against JAX is tests/test_torch_aot.py."""

import json
import os

import numpy as np
import torch

from object_detection_tracking_tpu.utils.weights import load_npz_tree
from object_detection_tracking_tpu_torch.cli import main as pack_cli
from object_detection_tracking_tpu_torch.models import get_model
from object_detection_tracking_tpu_torch.params import params_from_jax
from object_detection_tracking_tpu_torch.runtime import aot
from torch_port_common import one_torch_thread  # noqa: F401

# JAX's test_pack_mode_smoke flags (tests/test_quality.py:104-117)
SMOKE = ["--version", "2", "--num_class", "4", "--resnet18",
         "--short_edge_size", "64", "--max_size", "64",
         "--compute_dtype", "float32", "--rpn_test_post_nms_topk", "32",
         "--result_per_im", "8", "--device", "cpu"]


def pack(tmp, name, *flags):
    pack_cli.main(["pack", "--outbasepath", str(tmp), "--modelname", name,
                 *flags])
    return os.path.join(str(tmp), name, "packed")


def image():
    return torch.from_numpy(np.random.RandomState(0).randint(
        0, 255, (1, 64, 64, 3), np.uint8))


def _live(out_dir):
    """The port's live forward on a pack's config and params.npz
    (``params_from_jax`` widens float16 leaves to float32 on the host)."""
    from object_detection_tracking_tpu_torch.config import DetectorConfig
    with open(os.path.join(out_dir, "config.json")) as f:
        raw = json.load(f)
    raw.pop("pack")
    cfg = DetectorConfig.from_json(json.dumps(raw))
    tree = load_npz_tree(os.path.join(out_dir, "params.npz"))
    return params_from_jax(tree, get_model(cfg)).eval()


def test_cli_pack_smoke(tmp_path, capsys):
    out = pack(tmp_path, "packed", *SMOKE)
    assert "GFLOP/frame" in capsys.readouterr().out
    for name in ("params.npz", "config.json", "forward.pt2"):
        assert os.path.exists(os.path.join(out, name))
    cfg, params, fn = aot.load_packed(out, "cpu")
    assert aot.aot_compile(fn, params, torch.zeros(1)) is fn  # the CPU
    img = image()
    got = fn(params, img)
    ref = _live(out)(img)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_cli_pack_float16_params(tmp_path):
    out = pack(tmp_path, "p16", *SMOKE, "--pack_params_dtype", "float16")
    cfg, params, fn = aot.load_packed(out, "cpu")
    nbytes = {}
    for t in params.values():
        nbytes[t.dtype] = nbytes.get(t.dtype, 0) + t.numel() * t.element_size()
    assert nbytes[torch.float16] > 0.9 * (nbytes[torch.float16]
                                          + nbytes.get(torch.float32, 0))
    img = image()
    got = fn(params, img)
    # the live f32 model on the same weights widened on the host
    ref = _live(out)(img)
    np.testing.assert_allclose(got["final_boxes"].numpy(),
                               ref["final_boxes"].numpy(), atol=0.5)
    np.testing.assert_array_equal(got["final_labels"].numpy(),
                                  ref["final_labels"].numpy())
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
