"""The port's train CLI (cli/main.py) on the CPU: a few steps on
data/synthetic.py's dataset with the trained tree written as the JAX
package's native .npz, a resumed run equal to an uninterrupted one
(float32 params to 1e-5 relative, as tests/test_train.py::
test_resume_matches_uninterrupted_run), ``--device cuda`` raising without
a GPU. tests/test_torch_train_npz.py loads that .npz into the JAX
package."""

import os

import numpy as np
import pytest
import torch

from object_detection_tracking_tpu_torch.cli import main as M
from object_detection_tracking_tpu_torch.data.synthetic import \
    generate_dataset
from object_detection_tracking_tpu_torch.params import (load_npz_tree,
                                                        params_to_jax)
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import flat, train_batch

H, W = 48, 64
SMALL = ["--resnet18", "--short_edge_size", str(H), "--max_size", str(W),
         "--rpn_train_post_nms_topk", "32", "--rpn_batch_size", "32",
         "--frcnn_batch_size", "16", "--rpn_test_post_nms_topk", "32",
         "--result_per_im", "8", "--version", "2", "--device", "cpu"]


def _synthetic_args(tmp_path, *extra):
    data = str(tmp_path / "data")
    lst = generate_dataset(data, 4, image_hw=(H, W), seed=0)
    out = str(tmp_path / "runs")
    return out, M.get_args(
        ["train", "--trainlst", lst, "--framepath",
         os.path.join(data, "frames"), "--annopath", os.path.join(data, "anno"),
         "--outbasepath", out, "--im_batch_size", "2"] + list(extra) + SMALL)


def test_train_cli_on_synthetic_data(tmp_path):
    """Three steps of ``main.py train --add_mask`` on data/synthetic.py's
    frames and box-local masks: finite losses, the checkpoints, and a
    final.npz holding the trained model's tree."""
    out, args = _synthetic_args(tmp_path, "--add_mask", "--num_step", "3",
                                "--save_every", "2", "--freeze", "0")
    res = M.mode_train(args)
    assert res["step"] == 3 and len(res["losses"]) == 3
    assert all(np.isfinite(res["losses"]))
    assert sorted(os.listdir(os.path.join(out, "odt", "save"))) == [
        "step_2.pt", "step_3.pt"]
    tree = flat(load_npz_tree(os.path.join(out, "odt", "final.npz")))
    model = res["trainer"].model
    assert set(tree) == set(flat(params_to_jax(model)))
    for k, v in flat(params_to_jax(model)).items():
        np.testing.assert_array_equal(tree[k], v, err_msg=k)
    assert "maskrcnn/fcn0/W" in tree


class RepeatBatch:
    """One batch, yielded ``n`` times per epoch (``batches`` as
    DetectionTrainDataset has it); raises after ``stop_after`` yields."""

    def __init__(self, n, stop_after=None):
        self.batch = train_batch(h=H, w=W, num_class=16)[:4]
        self.num_samples = 2 * n
        self.stop_after = stop_after

    def batches(self, epochs=1):
        for i in range(self.num_samples // 2 * epochs):
            if i == self.stop_after:
                raise KeyboardInterrupt
            yield self.batch


def test_resumed_train_matches_uninterrupted(tmp_path):
    """Six steps in one run against three, a checkpoint, an interruption
    and a resumed run: the same params (the momentum slots, the step count
    and the warmup + cosine schedule survive the round trip, and each
    step's draws come from its step number)."""
    def run(outdir, data):
        args = M.get_args(["train", "--outbasepath", str(outdir),
                           "--im_batch_size", "2", "--num_step", "6",
                           "--save_every", "3", "--warmup_steps", "2",
                           "--init_lr", "0.01", "--clip_gradient_norm",
                           "10", "--freeze", "-1"] + SMALL)
        return M.mode_train(args, dataset=data)

    whole = run(tmp_path / "a", RepeatBatch(6))
    with pytest.raises(KeyboardInterrupt):
        run(tmp_path / "b", RepeatBatch(6, stop_after=3))
    assert os.listdir(tmp_path / "b" / "odt" / "save") == ["step_3.pt"]
    resumed = run(tmp_path / "b", RepeatBatch(6))
    assert whole["step"] == resumed["step"] == 6
    assert len(resumed["losses"]) == 3
    np.testing.assert_allclose(resumed["losses"], whole["losses"][3:],
                               rtol=1e-5)
    a = whole["trainer"].model.state_dict()
    b = resumed["trainer"].model.state_dict()
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert resumed["trainer"].step_count == 6


def test_train_cli_device_and_unported_modes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        M.main(["train", "--trainlst", "x"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        M.main(["test"])
    with pytest.raises(SystemExit) as exit_:      # JAX's forward mode
        M.main(["forward"])
    assert exit_.value.code == 2
    # pack is ported (runtime/aot.py): like train and test it asks for
    # --device cpu where there is no GPU
    with pytest.raises(RuntimeError, match="--device cpu"):
        M.main(["pack"])
