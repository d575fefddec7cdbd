"""The float32 reference against the port at a tiny size on the CPU, both
from the same seeded tree: every output of the forward."""

import numpy as np
import pytest
import torch

from benchmark.harness.traffic import render_ring
from benchmark.harness.weights import load_into, seeded_tree
from benchmark.reference.detector import ReferenceDetector
from benchmark.tests.tiny import tiny_files


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["actev_video_1080p", "meva_video_720p"])
def test_reference_matches_port(cell):
    from object_detection_tracking_tpu_torch.cli import \
        obj_detect_tracking as cli
    from object_detection_tracking_tpu_torch.models import get_model
    files = tiny_files(cell)
    conf = files["config"]
    args = cli.get_args(["--video_dir", ".", "--video_lst_file", "x",
                         "--device", "cpu"] + conf["cli"]
                        + files["cell"]["cli"])
    cfg = cli.build_config(args, torch.device("cpu"))
    model = get_model(cfg, "faster_rcnn").eval()
    tree = seeded_tree([(n, tuple(p.shape))
                        for n, p in model.named_parameters()],
                       2 ** 31 + 5, "cpu", conf["weights"])
    load_into(model, tree)
    ring = render_ring(files["traffic"], 11, 8)
    x = torch.from_numpy(np.stack(ring[:2]))
    got = model(x)
    want = ReferenceDetector(tree, conf["model"]).detect(x)
    assert set(want) <= set(got)
    assert torch.equal(got["final_valid"], want["final_valid"])
    assert torch.equal(got["final_labels"].long(), want["final_labels"])
    assert int(want["final_valid"].sum()) > 0
    for k in ("final_boxes", "final_probs", "pooled_box_feat",
              "final_masks"):
        if k in want:
            err = (got[k] - want[k]).abs().max().item()
            assert err <= 1e-4 * max(1.0, want[k].abs().max().item()), k
