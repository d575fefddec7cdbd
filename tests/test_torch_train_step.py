"""The port's train step against the JAX package on the CPU, at R18 and
48x64 in float32: one Trainer step against JAX's (momentum, weight decay,
a gradient clip that bites, freeze=2, the mask loss), and the overfit check
that mirrors tests/test_train.py.

Tolerance of the step: each new param within 2e-2 of the largest update of
its leaf, plus two float32 steps of its value. The update is made of the
gradients, which tests/test_torch_train_grads.py holds to 2e-2 of each
leaf's largest magnitude (relu and max-pool ties that rounding flips), and
an update smaller than the param's own spacing rounds either way."""

import jax
import numpy as np
import pytest
import torch

from object_detection_tracking_tpu.config import TrainConfig as JTrainConfig
from object_detection_tracking_tpu.models import get_model as jax_model
from object_detection_tracking_tpu.train import Trainer as JTrainer
from object_detection_tracking_tpu_torch.config import TrainConfig
from object_detection_tracking_tpu_torch.models import get_model
from object_detection_tracking_tpu_torch.params import (params_from_jax,
                                                        params_to_jax)
from object_detection_tracking_tpu_torch.train import Trainer
from torch_port_common import one_torch_thread  # noqa: E402,F401
from torch_port_common import (flat, jax_params, train_batch, train_configs,
                               train_setup)

T = torch.from_numpy


def test_trainer_step_matches_jax():
    """One momentum step with weight decay and a clip that bites, freeze=2
    and the mask loss: params equal JAX's after the step. Frozen "W" leaves
    move by weight decay alone, frozen BN leaves stay, and the BN leaves of
    the trained groups move."""
    jm, params, batch, rng, noise, tm, tbatch = train_setup(2, True)
    kw = dict(optimizer="momentum", init_lr=0.01, warmup_steps=0,
              total_steps=10, lr_schedule="constant", wd=1e-2,
              clip_gradient_norm=1.0)
    jtr = JTrainer(jm, JTrainConfig(**kw))
    state, jlosses = jtr.step_fn()(jtr.init_state(params), *batch[:4], rng,
                                   batch[4])
    trainer = Trainer(tm, TrainConfig(**kw))
    losses = trainer.step(*tbatch[:4], tbatch[4], noise=noise)
    assert float(losses["total_loss"]) == pytest.approx(
        float(jlosses["total_loss"]), rel=1e-5)
    before = flat(params)
    got = flat(params_to_jax(tm))
    ref = flat(jax.tree.map(np.asarray, state["params"]))
    for name, r in ref.items():
        step = np.abs(r - before[name]).max()
        tol = 2e-2 * step + 2 * np.finfo(np.float32).eps * np.abs(r)
        assert (np.abs(got[name] - r) <= tol).all(), name
        moved = np.abs(got[name] - before[name]).max() > 0
        frozen = name.startswith(("resnet/conv0/", "resnet/group0/",
                                  "resnet/group1/", "resnet/group2/"))
        if frozen:
            assert moved == name.endswith("/W"), name
        elif "/bn/" in name:
            assert moved, name


def test_train_step_overfits_single_batch():
    """The port's counterpart of tests/test_train.py::
    test_train_step_overfits_single_batch: 12 momentum steps at a constant
    0.01 on one batch and one draw; the tail must fall well below the
    start."""
    jcfg, tcfg = train_configs(freeze=-1)
    model = params_from_jax(jax_params(jax_model(jcfg)), get_model(tcfg))
    trainer = Trainer(model, TrainConfig(
        optimizer="momentum", init_lr=0.01, warmup_steps=0, total_steps=50,
        lr_schedule="constant", wd=0.0, clip_gradient_norm=10.0))
    images, gt_boxes, gt_labels, gt_valid, _ = train_batch()
    batch = [T(x) for x in (images, gt_boxes, gt_labels, gt_valid)]
    gen = torch.Generator()
    totals = []
    for _ in range(12):
        gen.manual_seed(42)
        total = float(trainer.step(*batch, generator=gen)["total_loss"])
        assert np.isfinite(total)
        totals.append(total)
    assert trainer.step_count == 12
    assert np.mean(totals[-3:]) < 0.65 * totals[0], totals
