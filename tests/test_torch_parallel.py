"""The port's data and tensor parallelism (parallel/mesh.py) on the CPU:
the TP rule and the sharded train step against the JAX package's mesh
(tests/test_parallel.py) and against the port's one-process step. The
ranks are CPU processes joined by gloo, started by
tests/torch_parallel_workers.py (which imports no JAX), one torch thread
each, every group with a 60 s timeout and every spawn joined within 240 s:
two ranks (a 2x1 mesh) and four (a 2x2 mesh) run test_torch_train_step.py's
R18 step at 48x64, float32, with JAX's draws, without the mask head.
test_torch_parallel_paths.py holds the other paths (batch_bn,
EfficientDet, the sharded eval, ``main.py train``, the runner).

The tolerances:
  * against JAX's sharded step: test_torch_train_step.py's, each param
    within 2e-2 of its leaf's largest update plus two float32 steps of its
    value (the gradients agree to relu/max-pool ties);
  * against the port's one-process step: within 1e-5 of each leaf's
    largest update plus two float32 steps of its value (an update below a
    param's own spacing rounds either way); the gradients differ only in
    the order of the sums over images and over the split kernels' halves.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from object_detection_tracking_tpu.config import TrainConfig as JTrainConfig
from object_detection_tracking_tpu.models import get_model as jax_model
from object_detection_tracking_tpu.parallel import make_mesh as jax_mesh
from object_detection_tracking_tpu.parallel import \
    make_sharded_train_step as jax_sharded_step
from object_detection_tracking_tpu.parallel import \
    param_shardings as jax_param_shardings
from object_detection_tracking_tpu.train import Trainer as JTrainer
from object_detection_tracking_tpu_torch.config import TrainConfig
from object_detection_tracking_tpu_torch.models import get_model
from object_detection_tracking_tpu_torch.params import (init_params,
                                                        params_from_jax,
                                                        params_to_jax)
from object_detection_tracking_tpu_torch.parallel.mesh import (
    Mesh, param_shardings)
from object_detection_tracking_tpu_torch.train import Trainer
from torch_parallel_workers import (EPS, STEP, check_against_one,
                                    load_results, save_inputs, spawn)
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import (flat, forward_train_noise, train_batch,
                               train_configs)


@pytest.fixture(scope="module")
def case():
    """The R18 case (JAX model, params, batch, key; the port's batch and
    draws) and the params after the port's one-process step. The params
    are the port's seeded init of JAX's tree (JAX's eager init takes 13 s
    here), each residual branch's last BN gamma scaled by 0.2 as
    ``jax_params`` does."""
    jcfg, tcfg = train_configs(freeze=2, add_mask=False)
    jm = jax_model(jcfg)
    params = init_params(tcfg, seed=0)
    for gname, group in params["resnet"].items():
        if gname.startswith("group"):
            for blk in group.values():
                last = blk["conv3"] if "conv3" in blk else blk["conv2"]
                last["bn"]["gamma"] = last["bn"]["gamma"] * 0.2
    batch = train_batch()
    rng = jax.random.PRNGKey(3)
    noise = forward_train_noise(jm, rng, 2, 48, 64,
                                jcfg.rpn_train_post_nms_topk, 4)
    tm = params_from_jax(params, get_model(tcfg))
    tb = [torch.from_numpy(x) for x in batch[:4]] + [None]
    inputs = dict(cfg=tm.config, batch=tb, noise=noise, kw=STEP,
                  state={k: v.clone() for k, v in tm.state_dict().items()})
    Trainer(tm, TrainConfig(**STEP)).step(*tb[:4], noise=noise)
    return dict(jm=jm, params=params, batch=batch, rng=rng,
                one=flat(params_to_jax(tm)), inputs=inputs)


def _sharded_run(tmp_path_factory, case, mesh):
    """The results of the ranks of an n_data x n_model mesh that ran one
    step of the case."""
    n_data, n_model = mesh
    tmp = str(tmp_path_factory.mktemp(f"mesh{n_data}x{n_model}"))
    save_inputs(tmp, "train_step", mesh=mesh, **case["inputs"])
    spawn(["train_step"], n_data * n_model, tmp)
    return load_results(tmp, "train_step", n_data * n_model), case


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, case):
    return _sharded_run(tmp_path_factory, case, (2, 1))


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, case):
    return _sharded_run(tmp_path_factory, case, (2, 2))


def _jax_sharded(ref, n_data, n_model):
    """Params after JAX's make_sharded_train_step on an n_data x n_model
    CPU mesh."""
    mesh = jax_mesh(n_data, n_model,
                    devices=jax.devices()[:n_data * n_model])
    jtr = JTrainer(ref["jm"], JTrainConfig(**STEP), mesh=mesh)
    state, step = jax_sharded_step(jtr, ref["params"], mesh)
    with mesh:
        state, _ = step(state, *ref["batch"][:4], ref["rng"])
    return flat(jax.tree.map(np.asarray, state["params"]))


def _check_against_jax(got, jref, before):
    assert set(got) == set(jref)
    for name, r in jref.items():
        step = np.abs(r - before[name]).max()
        tol = 2e-2 * step + 2 * EPS * np.abs(r)
        assert (np.abs(got[name] - r) <= tol).all(), name


def test_tp_rule_picks_jax_leaves():
    """``param_shardings`` splits over "model" exactly the kernels JAX's
    rule splits (the dense kernels with an output dim >= 1024 and a
    multiple of 8), by the names ``params_from_jax`` maps: on R50 with the
    SE blocks and the relation head, fc6, fc7, the relation projections
    and the late SE expansions; no leaf on a model axis of 1."""
    from object_detection_tracking_tpu_torch.config import \
        DetectorConfig as PortConfig
    cfg = PortConfig(num_class=4, resnet_depth=50, short_edge_size=48,
                     max_size=64, use_se=True, add_relation_nn=True,
                     compute_dtype="float32")
    model = get_model(cfg)
    tree = init_params(cfg, seed=0)
    ref = jax_param_shardings(tree, jax_mesh(4, 2))
    ref = {k for k, v in flat(jax.tree.map(
        lambda s: np.asarray(s.spec == jax.sharding.PartitionSpec(
            None, "model")), ref)).items() if v}
    mesh = Mesh(4, 2, 0, None, None, torch.device("cpu"))
    got = {k for k, v in param_shardings(model, mesh).items() if v}
    assert got == ref
    assert {"fastrcnn/fc6/W", "fastrcnn/fc7/W"} <= got
    assert any("/se/" in k or "fc2" in k for k in got), got
    assert not any(param_shardings(
        model, dataclasses.replace(mesh, n_data=8, n_model=1)).values())


def test_dp_step_matches_jax_sharded_and_one_process(two_ranks):
    """Two data ranks, one image each: the params after one step equal
    JAX's make_sharded_train_step on a 2x1 CPU mesh and the port's
    one-process step, on both ranks; the losses are the global batch's."""
    outs, ref = two_ranks
    before = flat(ref["params"])
    jref = _jax_sharded(ref, 2, 1)
    for out in outs:
        _check_against_jax(out["params"], jref, before)
        check_against_one(out["params"], ref["one"], before)
        assert out["split"] == []
    assert outs[0]["losses"] == outs[1]["losses"]
    assert np.isfinite(outs[0]["losses"]["total_loss"])


def test_dp_tp_step_matches_jax_sharded_and_one_process(four_ranks):
    """A 2x2 mesh: fc6 and fc7 split over "model" (each rank holds half of
    their output columns), the batch over "data"; the gathered params
    equal JAX's sharded step on a 2x2 CPU mesh and the one-process step."""
    outs, ref = four_ranks
    before = flat(ref["params"])
    jref = _jax_sharded(ref, 2, 2)
    assert sorted(o["mesh"] for o in outs) == [(0, 0), (0, 1), (1, 0),
                                               (1, 1)]
    for out in outs:
        assert out["split"] == ["fastrcnn/fc6/W", "fastrcnn/fc7/W"]
        for k in out["split"]:
            assert out["local_shapes"][k] == (before[k].shape[0],
                                              before[k].shape[1] // 2), k
        _check_against_jax(out["params"], jref, before)
        check_against_one(out["params"], ref["one"], before)
    assert len({o["losses"]["total_loss"] for o in outs}) == 1
