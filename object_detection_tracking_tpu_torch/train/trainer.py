"""Optimizer, LR schedule and the train step (port of
object_detection_tracking_tpu/train/trainer.py).

The JAX trainer chains optax transforms: ``clip_by_global_norm``, then
``add_decayed_weights`` on the "W" leaves (conv and dense kernels, the
reference's wd_cost, nn.py:51), then sgd / momentum / adam / adadelta,
scaled by the LR schedule read at the update count 0, 1, ... . The
machine that runs the port has no optax, so ``Optimizer`` builds that
chain from torch.optim's classes, which do the same arithmetic; the global
clip is written by hand because ``torch.nn.utils.clip_grad_norm_`` adds
1e-6 to the norm and optax does not. ``jax.grad`` gives every leaf a
gradient, zeros where no path reaches it (the frozen groups, a head without
targets); ``Trainer`` fills those zeros, so weight decay still moves frozen
"W" leaves, as optax does.

The JAX trainer's mesh is ``parallel/mesh.py make_sharded_train_step``,
which runs this trainer's ``losses``, ``backward`` and ``apply_gradients``
with the gradients averaged over the data ranks between the last two.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..config import TrainConfig
from .. import params as params_lib


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """Linear warmup -> hold -> cosine/exp decay (trainer.py:49-86): the
    learning rate at update count ``step``."""
    def schedule(step: int) -> float:
        step = float(step)
        if step < cfg.warmup_steps:
            return cfg.warmup_init_lr + (cfg.init_lr - cfg.warmup_init_lr) \
                * (step / max(cfg.warmup_steps, 1))
        t = min(max((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
        if cfg.lr_schedule == "cosine":
            return cfg.init_lr * 0.5 * (1 + math.cos(math.pi * t))
        if cfg.lr_schedule == "exp":
            return cfg.init_lr * math.pow(0.01, t)
        return cfg.init_lr
    return schedule


class Optimizer:
    """optax's chain (module note) over named parameters. ``decay`` names
    the parameters that take weight decay. The global clip is done here;
    the decay and the update are ``torch.optim``'s multi-tensor (foreach)
    SGD, Adam or Adadelta in two parameter groups (decayed, not decayed),
    which compute optax's ``add_decayed_weights`` followed by its sgd /
    momentum / adam / adadelta: the decay is added to the gradient before
    the update, and SGD's first momentum buffer (a copy of the gradient)
    equals optax's trace started at zero. The learning rate is set from the
    schedule at the update count before each update."""

    def __init__(self, params: Dict[str, nn.Parameter], decay,
                 cfg: TrainConfig):
        if cfg.optimizer not in ("sgd", "momentum", "adam", "adadelta"):
            raise ValueError(cfg.optimizer)
        self.params = params
        self.decay = set(decay)
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.init_state()

    def init_state(self) -> None:
        cfg = self.cfg
        groups = [{"params": [p for n, p in self.params.items()
                              if n in self.decay], "weight_decay": cfg.wd},
                  {"params": [p for n, p in self.params.items()
                              if n not in self.decay], "weight_decay": 0.0}]
        if cfg.optimizer in ("sgd", "momentum"):
            self.torch_opt = torch.optim.SGD(
                groups, lr=0.0, foreach=True, momentum=(
                    cfg.momentum if cfg.optimizer == "momentum" else 0.0))
        elif cfg.optimizer == "adam":
            self.torch_opt = torch.optim.Adam(
                groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8, foreach=True)
        else:
            self.torch_opt = torch.optim.Adadelta(groups, lr=0.0, rho=0.9,
                                                  eps=1e-6, foreach=True)
        self.count = 0

    def grad_norm(self, grads) -> torch.Tensor:
        """The global norm the clip reads (parallel/mesh.py replaces it
        where kernels are split over devices). torch's CPU norm sums each
        tensor's squares in one running float32 sum (5.4e-4 low on a
        12.8M-element fc6 gradient); optax's and torch's CUDA reductions
        sum in trees, and on the CPU ``torch.sum``'s cascade does."""
        if grads[0].device.type == "cpu":
            return torch.stack([g.float().square().sum()
                                for g in grads]).sum().sqrt()
        return torch.nn.utils.get_total_norm(grads)

    @torch.no_grad()
    def step(self) -> None:
        """One update from each parameter's ``.grad`` (all must be set)."""
        cfg = self.cfg
        if cfg.clip_gradient_norm:
            grads = [p.grad for p in self.params.values()]
            g_norm = self.grad_norm(grads)
            scale = torch.where(g_norm < cfg.clip_gradient_norm,
                                torch.ones_like(g_norm),
                                cfg.clip_gradient_norm / g_norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.count)
        for group in self.torch_opt.param_groups:
            group["lr"] = lr
        self.torch_opt.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "torch": self.torch_opt.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.torch_opt.load_state_dict(state["torch"])


class Trainer:
    """The train step of a model built with ``is_train``: ``losses``
    (forward and losses), ``backward`` (gradients, zeros where none flows),
    ``apply_gradients`` (one optimizer update); ``step`` runs the three."""

    def __init__(self, model: nn.Module, train_cfg: TrainConfig):
        self.model = model
        self.cfg = train_cfg
        params, decay = {}, []
        for path, t, _ in params_lib._leaves(model):
            name = "/".join(path)
            params[name] = t
            if path[-1] == "W":
                decay.append(name)
        if {id(p) for p in params.values()} != \
                {id(p) for p in model.parameters()}:
            raise ValueError("the model has parameters outside its JAX tree")
        self.opt = Optimizer(params, decay, train_cfg)

    def init_state(self) -> None:
        """Fresh optimizer state and update count (optax ``init``)."""
        self.opt.init_state()

    @property
    def step_count(self) -> int:
        return self.opt.count

    def losses(self, images, gt_boxes, gt_labels, gt_valid, gt_masks=None,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict[str, torch.Tensor]] = None,
               sync_group=None):
        return self.model.forward_train(images, gt_boxes, gt_labels, gt_valid,
                                        gt_masks=gt_masks,
                                        generator=generator, noise=noise,
                                        sync_group=sync_group)

    def backward(self, losses: Dict[str, torch.Tensor]) -> None:
        for p in self.opt.params.values():
            p.grad = None
        losses["total_loss"].backward()
        for p in self.opt.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    def apply_gradients(self) -> None:
        self.opt.step()

    def step(self, images, gt_boxes, gt_labels, gt_valid, gt_masks=None,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        """One train step; returns the detached losses."""
        losses = self.losses(images, gt_boxes, gt_labels, gt_valid, gt_masks,
                             generator, noise)
        self.backward(losses)
        self.apply_gradients()
        return {k: v.detach() for k, v in losses.items()}

    def state_dict(self) -> Dict:
        """Params, optimizer state and step: what a resume needs."""
        return {"params": self.model.state_dict(),
                "opt": self.opt.state_dict(), "step": self.opt.count}

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["params"])
        self.opt.load_state_dict(state["opt"])
