"""Data and tensor parallelism over ``torch.distributed`` (port of
object_detection_tracking_tpu/parallel/mesh.py:1-98).

The JAX package lays its devices out as a ("data", "model") mesh and
lets GSPMD place the collectives. Here the mesh is one process per device
(launched by ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``), NCCL between cards
and gloo on the CPU, and the collectives are explicit:

  * DP (``make_sharded_train_step``, ``rank_batches``): every rank
    decodes its rows of the global batch alone and makes the others'
    random draws too; the random subsamples draw the global batch's
    uniforms and keep the rank's rows (``RowDraws``); after the backward
    the gradients are averaged over "data" (one flat all-reduce, none on
    one rank), so the global clip and the update see the global batch's
    gradient. The R-CNN losses are means over images, so equal shards
    average to the global loss. The step hands the models its data group
    (``sync_group``): ``batch_bn``'s statistics are sums over "data"
    (JAX's are global under pjit) and EfficientDet's focal normaliser
    counts the positives of the whole batch (``data_sum``).
  * TP (``param_shardings``, JAX's ``_is_tp_dense``): a dense kernel whose
    output dim is at least 1024 and divisible by 8 is split on that dim
    over "model". JAX's ``W`` is [in, out]; ``nn.Linear.weight`` is
    [out, in], so the rule reads ``weight.shape[0]``. The split layer is
    column-parallel (``layers.linear``): the input enters through an
    identity whose backward sums over "model", each rank multiplies by its
    rows of the kernel, and the outputs are all-gathered (backward: the
    rank's slice); the bias stays whole and is added after the gather, as
    JAX keeps ``b`` replicated.
  * Inference fan-out (JAX ``make_sharded_infer_fn``: ``replicate``,
    ``split_batch``, ``on_device``): one model replica per device of one
    process, each batch split over them and the outputs put back in batch
    order (``runtime/runner.py DetectionRunner``, the video CLI).

Ranks are ``data_rank * n_model + model_rank``. Every process group is
made with an explicit timeout, so that a hung collective raises.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import itertools
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

TIMEOUT_S = 600.0


def launched_by_torchrun() -> bool:
    """True under ``torchrun`` (or any launcher that sets its variables)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def init_distributed(device_type: str, timeout_s: float = TIMEOUT_S
                     ) -> torch.device:
    """The default process group from torchrun's variables (NCCL for
    ``device_type`` "cuda", gloo for "cpu"), unless one exists; returns this
    rank's device (``cuda:LOCAL_RANK`` on the card)."""
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo", init_method="env://",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
            timeout=datetime.timedelta(seconds=timeout_s))
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        return device
    return torch.device("cpu")


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (data, model) mesh and its two groups."""

    n_data: int
    n_model: int
    rank: int
    data_group: object
    model_group: Optional[object]
    device: torch.device

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device: Optional[torch.device] = None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """The (data, model) mesh over the default group's ranks (JAX
    ``make_mesh``). Every rank calls it: each group is made by all."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} ranks")
    timeout = datetime.timedelta(seconds=timeout_s)
    d, m = divmod(rank, n_model)
    if n_data == world:
        data_group = dist.group.WORLD
    else:
        groups = [dist.new_group([i * n_model + j for i in range(n_data)],
                                 timeout=timeout) for j in range(n_model)]
        data_group = groups[m]
    model_group = None
    if n_model > 1:
        groups = [dist.new_group([i * n_model + j for j in range(n_model)],
                                 timeout=timeout) for i in range(n_data)]
        model_group = groups[d]
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend() == "nccl" else torch.device("cpu")
    return Mesh(n_data, n_model, rank, data_group, model_group, device)


# ----------------------------------------------------------------------
# the data axis inside a train step

def sync_group(mesh: Mesh):
    """The group a train step's batch statistics and loss normalisers sum
    over: ``mesh``'s data ranks, None for a data axis of one rank."""
    return None if mesh.n_data == 1 else mesh.data_group


def data_sum(t: torch.Tensor, group):
    """(sum of the detached ``t`` over ``group``'s ranks, their number):
    ``(t, 1)`` without a group."""
    if group is None:
        return t, 1
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t, dist.get_world_size(group)


# ----------------------------------------------------------------------
# tensor parallelism over "model"

def is_tp_dense(module: nn.Module) -> bool:
    """JAX's ``_is_tp_dense`` on a port layer: a dense kernel whose output
    dim is at least 1024 and divisible by 8."""
    if not isinstance(module, nn.Linear):
        return False
    out = module.weight.shape[0]
    return out % 8 == 0 and out >= 1024


def param_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[str]]:
    """{JAX tree name ("fastrcnn/fc6/W"): "model" for a kernel split over
    the model axis, None for a replicated leaf} (JAX ``param_shardings``:
    ``P(None, "model")`` or ``P()``)."""
    from .. import params as params_lib
    tp = {id(m.weight) for m in model.modules() if is_tp_dense(m)}
    return {"/".join(path): ("model" if mesh.n_model > 1 and id(t) in tp
                             else None)
            for path, t, _ in params_lib._leaves(model)}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the
    model ranks (each holds the part its kernel rows give)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the model ranks' output columns along the last dim;
    the backward keeps this rank's columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, y, group, rank, size):
        ctx.rank, ctx.k = rank, y.shape[-1]
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        k = ctx.k
        return grad[..., ctx.rank * k:(ctx.rank + 1) * k], None, None, None


@dataclasses.dataclass
class _Shard:
    group: object
    rank: int
    size: int


def column_parallel_linear(p: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``p``'s full output from this rank's rows of its kernel: the layer
    ``shard_params`` split (``layers.linear`` calls it)."""
    s: _Shard = p.tp
    x = _CopyToModel.apply(x, s.group)
    y = nn.functional.linear(x, p.weight.to(x.dtype))
    y = _GatherFromModel.apply(y, s.group, s.rank, s.size)
    return y if p.bias is None else y + p.bias.to(y.dtype)


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Split each TP dense kernel of ``model`` over the model axis in
    place: the module keeps this rank's rows as its ``weight`` (a new
    Parameter) and a ``tp`` record. No-op on a model axis of 1."""
    if mesh.n_model == 1:
        return model
    for m in model.modules():
        if is_tp_dense(m):
            k = m.weight.shape[0] // mesh.n_model
            rows = m.weight.detach()[mesh.model_rank * k:
                                     (mesh.model_rank + 1) * k]
            m.weight = nn.Parameter(rows.clone(),
                                    requires_grad=m.weight.requires_grad)
            m.tp = _Shard(mesh.model_group, mesh.model_rank, mesh.n_model)
    return model


@torch.no_grad()
def unshard_params(model: nn.Module) -> nn.Module:
    """Gather every split kernel back to its whole weight in place (on
    every model rank): before a checkpoint or ``params_to_jax``."""
    for m in model.modules():
        s = getattr(m, "tp", None)
        if s is None:
            continue
        parts = [torch.empty_like(m.weight) for _ in range(s.size)]
        dist.all_gather(parts, m.weight.contiguous(), group=s.group)
        m.weight = nn.Parameter(torch.cat(parts, 0),
                                requires_grad=m.weight.requires_grad)
        del m.tp
    return model


def _grad_norm(params: Sequence[nn.Parameter], split, model_group):
    """The global gradient norm when the leaves ``split`` (ids) are split
    over the model axis: the replicated leaves' squares once, the split
    ones' summed over the model ranks."""
    is_split = [id(p) in split for p in params]

    def sq(grads, want):
        ts = [g.float().square().sum()
              for g, s in zip(grads, is_split) if s == want]
        return torch.stack(ts).sum() if ts else \
            torch.zeros((), device=grads[0].device)

    def norm(grads):
        s = sq(grads, True)
        dist.all_reduce(s, group=model_group)
        return (sq(grads, False) + s).sqrt()
    return norm


# ----------------------------------------------------------------------
# the train step

def _rows(mesh: Mesh, batch: int) -> slice:
    if batch % mesh.n_data:
        raise ValueError(f"batch {batch} does not divide over "
                         f"{mesh.n_data} data ranks")
    k = batch // mesh.n_data
    return slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)


def all_reduce_grads(params: Sequence[nn.Parameter], mesh: Mesh) -> None:
    """Average every ``.grad`` over the data axis: one flat all-reduce after
    the backward (nothing on a data axis of one rank)."""
    if mesh.n_data == 1:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.n_data)
    torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def _stand_in(ds):
    """What a row another rank decodes gives ``ds.batches()`` here: a 1x1
    image without boxes, after the random draws its ``_load_one`` makes
    (``DetectionTrainDataset``'s short-edge jitter; ``CocoTrainDataset``
    makes none)."""
    from ..data.coco import CocoTrainDataset
    if ds.short_edge_jitter is not None and ds.shuffle and \
            not isinstance(ds, CocoTrainDataset):
        ds.rng.randint(*ds.short_edge_jitter)
    ms = ds.mask_size
    return (np.zeros((1, 1, 3), np.uint8), np.zeros((0, 4), np.float32),
            np.zeros(0, np.int32)) + \
        ((np.zeros((0, ms, ms), np.float32),) if ds.with_masks else ())


def _pad_over_data(images: np.ndarray, mesh: Mesh, ds, grow: bool):
    """``images`` padded to the largest (H, W) over the data ranks: the
    whole batch's shape. ``grow``: that shape is also the dataset's canvas
    (its jitter's grow-only canvas, which each rank grew by its own rows
    alone)."""
    shape = torch.tensor(images.shape[1:3], device=mesh.device)
    dist.all_reduce(shape, op=dist.ReduceOp.MAX, group=mesh.data_group)
    h, w = shape.tolist()
    if grow:
        ds._canvas = (h, w)
    if (h, w) == images.shape[1:3]:
        return images
    out = np.zeros((images.shape[0], h, w) + images.shape[3:], images.dtype)
    out[:, :images.shape[1], :images.shape[2]] = images
    return out


def rank_batches(ds, mesh: Mesh, epochs: int = 1, whole_shape: bool = True,
                 **kwargs):
    """``ds.batches(epochs, **kwargs)`` (a ``DetectionTrainDataset``, whose
    ``batch_size`` is the global batch) as this data rank's rows of each
    batch. The other rows are not decoded: a stand-in takes each one's
    place and makes its random draws, so every rank draws the whole
    batch's flips, jitter and mixup and the next epoch's order. With
    ``whole_shape`` the images are padded to the whole batch's shape (the
    largest over the data ranks), as a one-process batch is; else each
    rank's rows keep their own. On a data axis of one rank: the whole
    batches, as ``ds.batches`` gives them."""
    if mesh.n_data == 1:
        yield from ds.batches(epochs, **kwargs)
        return
    rows = _rows(mesh, ds.batch_size)
    per = 2 if ds.use_mixup else 1      # a mixup row loads its partner too
    calls = itertools.count()
    load = ds._load_one

    def load_one(*sample):
        if rows.start <= next(calls) // per % ds.batch_size < rows.stop:
            return load(*sample)
        return _stand_in(ds)

    grow = ds.short_edge_jitter is not None and kwargs.get("pad_to") is None
    own = vars(ds).get("_load_one")
    ds._load_one = load_one
    try:
        for batch in ds.batches(epochs, **kwargs):
            batch = tuple(x[rows] for x in batch)
            if whole_shape:
                batch = (_pad_over_data(batch[0], mesh, ds, grow),) + \
                    batch[1:]
            yield batch
    finally:
        if own is None:
            del ds._load_one
        else:
            ds._load_one = own


def make_sharded_train_step(model: nn.Module, train_cfg, mesh: Mesh):
    """Split ``model``'s TP kernels over ``mesh``'s model axis and return
    (trainer, step_fn) (JAX ``make_sharded_train_step``). ``step_fn(images,
    gt_boxes, gt_labels, gt_valid, gt_masks=None, generator=None,
    noise=None, rows_only=False)`` takes the global batch (any device),
    keeps this rank's rows of it and of the draws, runs the losses and
    backward on ``mesh.device``, averages the gradients over "data" and
    applies one update; it returns the global batch's losses (each averaged
    over the data ranks). The batch must divide over the data axis. With
    ``rows_only`` the tensors (and ``noise``) are this rank's rows already
    (``rank_batches``)."""
    from ..train import Trainer
    from ..train.targets import RowDraws
    shard_params(model, mesh)
    trainer = Trainer(model, train_cfg)
    params = list(trainer.opt.params.values())
    if mesh.n_model > 1:
        split = {id(m.weight) for m in model.modules()
                 if getattr(m, "tp", None) is not None}
        trainer.opt.grad_norm = _grad_norm(params, split, mesh.model_group)

    def step_fn(images, gt_boxes, gt_labels, gt_valid, gt_masks=None,
                generator=None, noise=None, rows_only=False):
        size = images.shape[0] * (mesh.n_data if rows_only else 1)
        rows = _rows(mesh, size)

        def mine(t):
            if t is None:
                return None
            return (t if rows_only else t[rows]).to(mesh.device)

        batch = [mine(t) for t in (images, gt_boxes, gt_labels, gt_valid,
                                   gt_masks)]
        if generator is not None:
            generator = RowDraws(generator, size, rows)
        if noise is not None:
            noise = {k: mine(v) for k, v in noise.items()}
        losses = trainer.losses(*batch, generator=generator, noise=noise,
                                sync_group=sync_group(mesh))
        trainer.backward(losses)
        all_reduce_grads(params, mesh)
        trainer.apply_gradients()
        losses = {k: v.detach().float() for k, v in losses.items()}
        if mesh.n_data == 1:
            return losses
        names = sorted(losses)
        vals = torch.stack([losses[k] for k in names])
        dist.all_reduce(vals, group=mesh.data_group)
        return dict(zip(names, (vals / mesh.n_data).unbind()))

    return trainer, step_fn


# ----------------------------------------------------------------------
# inference fan-out

def replicate(model: nn.Module, devices: Sequence[torch.device]
              ) -> List[nn.Module]:
    """``model`` on ``devices[0]`` and a copy on each other device."""
    model = model.to(devices[0])
    return [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]


def split_batch(replicas: Sequence[nn.Module], batch):
    """[(replica, its rows of ``batch``)]: consecutive equal parts, one a
    replica, when the batch divides over them; else the whole batch on the
    first replica."""
    n = len(replicas)
    if n == 1 or batch.shape[0] % n:
        return [(replicas[0], batch)]
    k = batch.shape[0] // n
    return [(r, batch[i * k:(i + 1) * k]) for i, r in enumerate(replicas)]


def on_device(device: torch.device):
    """A context with ``device`` as the current CUDA device (the CUDA
    runtime launches there, whatever stream is passed); none for the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
