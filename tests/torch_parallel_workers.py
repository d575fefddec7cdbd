"""Worker processes of tests/test_torch_parallel.py and
test_torch_parallel_paths.py: ``spawn`` starts ``world`` CPU ranks (gloo,
torchrun's environment variables set by hand, one torch thread each),
runs the named jobs in order in every rank and joins them within a
timeout. Each job reads its inputs from ``<tmp>/<job>_in.pt``
(``save_inputs``, called by the test, which alone imports JAX) and
leaves its rank's results in ``<tmp>/<job>_rank<r>.pt``
(``load_results``). Nothing here imports JAX or the JAX package: the
ranks run the port alone."""

import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

EPS = np.finfo(np.float32).eps
# test_torch_train_step.py's step: momentum, weight decay, a clip that bites
STEP = dict(optimizer="momentum", init_lr=0.01, warmup_steps=0,
            total_steps=10, lr_schedule="constant", wd=1e-2,
            clip_gradient_norm=1.0)


def save_inputs(tmp, job, **inputs):
    torch.save(inputs, os.path.join(tmp, f"{job}_in.pt"))


def load_results(tmp, job, world):
    return [torch.load(os.path.join(tmp, f"{job}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def check_against_one(got, one, before, invariant=None, rel=1e-5):
    """Each param of ``got`` within ``rel`` of its leaf's largest update
    (``one`` - ``before``) plus two float32 steps of its value; leaves
    matching ``invariant`` within ``rel`` of the largest update of any
    leaf."""
    assert set(got) == set(one)
    top = max(np.abs(one[k] - before[k]).max() for k in one)
    for name, r in one.items():
        step = top if invariant and invariant.search(name) else \
            np.abs(r - before[name]).max()
        tol = rel * step + 2 * EPS * np.abs(r)
        assert (np.abs(got[name] - r) <= tol).all(), name


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(jobs, world, tmp, timeout_s=240.0):
    """Run ``jobs`` (names in ``JOBS``) in ``world`` fresh ranks; raises if
    a rank fails or the ranks outlive ``timeout_s``."""
    port = _free_port()
    ctx = mp.start_processes(_worker, args=(world, port, str(tmp),
                                            tuple(jobs)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {jobs} still running "
                                   f"after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _worker(rank, world, port, tmp, jobs):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from object_detection_tracking_tpu_torch.parallel.mesh import \
        init_distributed
    init_distributed("cpu", timeout_s=60)
    try:
        for job in jobs:
            inputs = torch.load(os.path.join(tmp, f"{job}_in.pt"),
                                weights_only=False)
            out = JOBS[job](rank, inputs)
            torch.save(out, os.path.join(tmp, f"{job}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _model(cfg, state):
    from object_detection_tracking_tpu_torch.models import get_model
    model = get_model(cfg)
    model.load_state_dict(state)
    return model


def _tree(model):
    from object_detection_tracking_tpu_torch.params import params_to_jax
    out = {}

    def rec(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                rec(v, prefix + k + "/")
            else:
                out[prefix + k] = v
    rec(params_to_jax(model), "")
    return out


def train_step_job(rank, inp):
    """One sharded step on the (n_data, n_model) mesh ``inp["mesh"]``;
    returns the whole params (split kernels gathered), the losses and the
    TP leaves."""
    from object_detection_tracking_tpu_torch.config import TrainConfig
    from object_detection_tracking_tpu_torch.parallel.mesh import (
        make_mesh, make_sharded_train_step, param_shardings, unshard_params)
    n_data, n_model = inp["mesh"]
    mesh = make_mesh(n_data, n_model, timeout_s=60)
    model = _model(inp["cfg"], inp["state"])
    split = sorted(k for k, v in param_shardings(model, mesh).items() if v)
    trainer, step = make_sharded_train_step(model, TrainConfig(**inp["kw"]),
                                            mesh)
    local = {k: tuple(v.shape) for k, v in _tree(model).items()}
    losses = step(*inp["batch"], noise=inp.get("noise"))
    unshard_params(model)
    return {"params": _tree(model), "split": split, "local_shapes": local,
            "losses": {k: float(v) for k, v in losses.items()},
            "mesh": (mesh.data_rank, mesh.model_rank)}


def batch_bn_job(rank, inp):
    """``batch_bn`` on this rank's half of ``inp["x"]`` over the data
    ranks, with the gradients of sum(y * w): the output rows,
    the input gradient rows and the gamma/beta gradients summed over the
    ranks."""
    from object_detection_tracking_tpu_torch.ops.norm import (FrozenBN,
                                                              batch_bn)
    from object_detection_tracking_tpu_torch.parallel.mesh import (
        make_mesh, sync_group)
    mesh = make_mesh(timeout_s=60)
    x, w = inp["x"], inp["w"]
    k = x.shape[0] // mesh.n_data
    rows = slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)
    bn = FrozenBN(x.shape[1])
    with torch.no_grad():
        bn.gamma.copy_(inp["gamma"])
        bn.beta.copy_(inp["beta"])
    bn.gamma.requires_grad_(True)
    bn.beta.requires_grad_(True)
    xl = x[rows].clone().requires_grad_(True)
    y = batch_bn(bn, xl, group=sync_group(mesh))
    (y * w[rows]).sum().backward()
    grads = torch.stack([bn.gamma.grad, bn.beta.grad])
    dist.all_reduce(grads, group=mesh.data_group)
    return {"y": y.detach(), "dx": xl.grad, "dgamma": grads[0],
            "dbeta": grads[1]}


def eval_job(rank, inp):
    """``run_eval`` sharded over the data ranks: the AP and the images
    scored, with their detections and gt."""
    from types import SimpleNamespace

    from object_detection_tracking_tpu_torch.cli.main import run_eval
    from object_detection_tracking_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(timeout_s=60)
    model = _model(inp["cfg"], inp["state"])
    cache = {}
    ap = run_eval(SimpleNamespace(**inp["args"]), inp["cfg"], model,
                  cache=cache, mesh=mesh)
    return {"ap": ap, "scored": cache["scored"]}


def train_cli_job(rank, inp):
    """``main.py train`` under this rank's launcher variables, each rank
    with its own ``--outbasepath``: the trained params and the files each
    rank wrote."""
    from object_detection_tracking_tpu_torch.cli import main as M
    out = os.path.join(inp["out"], f"rank{rank}")
    args = M.get_args(inp["argv"] + ["--outbasepath", out])
    res = M.mode_train(args)
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    return {"params": _tree(res["trainer"].model), "files": files,
            "losses": res["losses"], "step": res["step"]}


JOBS = {"train_step": train_step_job, "batch_bn": batch_bn_job,
        "eval": eval_job, "train_cli": train_cli_job}
