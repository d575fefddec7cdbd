"""Train / test / forward / pack driver (port of
object_detection_tracking_tpu/cli/main.py:25-523).

  train:   the Faster/Mask R-CNN or EfficientDet train step with the JAX
           CLI's schedule and optimizer, on one device, or data-parallel
           over the ranks ``torchrun`` launches (parallel/mesh.py:
           NCCL between cards, gloo with ``--device cpu``; rank 0 writes
           the checkpoints; the periodic eval is sharded), periodic eval with
           best-checkpoint keeping; checkpoints with torch.save (params,
           optimizer state, step), so a resume continues momentum and the
           LR schedule. An EfficientDet's BN statistics are calibrated
           after the last step (``EfficientDet.calibrate_bn``), before the
           final checkpoint.
  test:    AP/AR of ``--load_from`` on the validation lst: a checkpoint
           ``load_weights`` reads (``.npz``: tensorpack/TF names or the
           native layout), or this driver's own ``step_<N>.pt``.
  forward: prints, as the JAX driver does, that cli.obj_detect_imgs is
           the batch image inference, and exits with code 2.
  pack:    not ported: the counterpart of the JAX package's
           runtime/aot.py waits for a captured CUDA graph (ROADMAP A12).

The same flags as the JAX CLI, plus ``--device`` (default cuda; with no GPU
it raises unless ``--device cpu`` is given). ``--compute_dtype`` defaults to
bfloat16 on the GPU and float32 on the CPU. The configuration takes
``roi_align_train_impl="pallas"``: on the GPU the box and mask heads' ROIAlign
runs kernel B1 forward and kernel B1b backward (ROADMAP C9). The final
params are also written as the JAX package's native flat ``.npz``
(``<outbasepath>/<modelname>/final.npz``), which both packages load.
``--load_from`` takes what the JAX driver's does (utils/weights.py
load_weights: a TF V2 checkpoint of the reference, a tensorpack-named
``.npz``, the native flat ``.npz``), laid over the seeded init; a native
npz name the model lacks raises ``KeyError``.

``train`` is the loop alone: it takes any dataset with
``DetectionTrainDataset``'s ``batches(epochs)`` interface, so a caller
without cv2 or files can feed batches from memory. As in the JAX CLI, no
flag selects EfficientDet: build its config (``model="efficientdet"``,
``efficientdet_name``, an ``efficientdet_image_size`` that is a multiple
of 128), its model with ``build_model``, and call ``train``.

Example:
  python -m object_detection_tracking_tpu_torch.cli.main train \\
    --trainlst train.lst --framepath frames --annopath anno --add_mask \\
    --im_batch_size 2 --num_step 1000 --device cuda
  torchrun --nproc_per_node 4 \\
    -m object_detection_tracking_tpu_torch.cli.main train ... \\
    --im_batch_size 8       # the global batch, 2 a card
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
import time
from collections import deque

import numpy as np
import torch

from ..config import DetectorConfig, TrainConfig
from ..models import get_model
from ..parallel.mesh import launched_by_torchrun
from ..params import (init_params, params_from_jax, params_to_jax,
                      save_npz_tree)
from ..train import Trainer
from ..utils.weights import load_weights
from .obj_detect_tracking import resolve_device


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("mode", choices=["train", "test", "forward", "pack"])
    p.add_argument("--trainlst")
    p.add_argument("--vallst")
    p.add_argument("--framepath")
    p.add_argument("--annopath")
    p.add_argument("--valframepath")
    p.add_argument("--valannopath")
    p.add_argument("--outbasepath", default="runs/detector")
    p.add_argument("--modelname", default="odt")
    p.add_argument("--load_from", default=None,
                   help="a TF V2 checkpoint (directory, prefix or .index), "
                   "a tensorpack-named .npz or the native flat .npz; test "
                   "also takes this driver's step_<N>.pt")
    p.add_argument("--ignore_vars", default=None,
                   help="':'-separated name substrings excluded from "
                   "--load_from restore (fine-tune with fresh heads, "
                   "ref models.py:3507-3525)")
    p.add_argument("--pack_params_dtype", default="float32",
                   choices=["float32", "float16"],
                   help="pack mode (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="cuda | cuda:N | cpu (no silent CPU fallback)")
    # model
    p.add_argument("--version", type=int, default=4)
    p.add_argument("--num_class", type=int, default=16)
    p.add_argument("--resnet18", action="store_true")
    p.add_argument("--resnet34", action="store_true")
    p.add_argument("--resnet50", action="store_true")
    p.add_argument("--resnet152", action="store_true")
    for flag in ("use_dilations", "use_deformable", "use_se", "use_resnext",
                 "use_gn", "use_frcnn_class_agnostic", "use_att_frcnn_head",
                 "use_conv_frcnn_head", "add_relation_nn", "focal_loss",
                 "use_small_object_head"):
        p.add_argument("--" + flag, action="store_true", default=None)
    p.add_argument("--rpn_batch_size", type=int, default=None,
                   help="rpn_batch_per_im (ref main.py --rpn_batch_size)")
    p.add_argument("--frcnn_batch_size", type=int, default=None,
                   help="fastrcnn_batch_per_im")
    p.add_argument("--fastrcnn_fg_ratio", type=float, default=None)
    p.add_argument("--positive_anchor_thres", type=float, default=None)
    p.add_argument("--negative_anchor_thres", type=float, default=None)
    p.add_argument("--rpn_test_post_nms_topk", type=int, default=None)
    p.add_argument("--rpn_train_pre_nms_topk", type=int, default=None)
    p.add_argument("--rpn_train_post_nms_topk", type=int, default=None)
    p.add_argument("--fastrcnn_nms_iou_thres", type=float, default=None)
    p.add_argument("--result_score_thres", type=float, default=None)
    p.add_argument("--result_per_im", type=int, default=None)
    p.add_argument("--max_size", type=int, default=1920)
    p.add_argument("--short_edge_size", type=int, default=1080)
    p.add_argument("--compute_dtype", default=None,
                   help="bfloat16 | float32; default bfloat16 on the GPU, "
                   "float32 on the CPU")
    p.add_argument("--add_mask", action="store_true",
                   help="train the Mask-RCNN head (needs 'masks' in the "
                   "npz annotations)")
    # train
    p.add_argument("--init_lr", type=float, default=0.003)
    p.add_argument("--optimizer", default="momentum")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--lr_schedule", default="cosine",
                   choices=["cosine", "exp", "constant"],
                   help="reference --use_cosine_schedule/--use_exp_schedule")
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--num_epochs", type=int, default=12)
    p.add_argument("--num_step", type=int, default=None,
                   help="cap total steps (overrides epochs*steps/epoch)")
    p.add_argument("--use_mixup", action="store_true",
                   help="Beta(1.5,1.5) two-frame mixup augmentation")
    p.add_argument("--scale_jitter", action="store_true",
                   help="short edge ~ U[short_edge_size_min, _max] per "
                   "train image (ref models.py:1522)")
    p.add_argument("--short_edge_size_min", type=int, default=640)
    p.add_argument("--short_edge_size_max", type=int, default=800)
    p.add_argument("--train_skip", type=int, default=1,
                   help="use every Nth training sample (ref --train_skip)")
    p.add_argument("--val_skip", type=int, default=1)
    p.add_argument("--skip_first_eval", action="store_true")
    p.add_argument("--im_batch_size", type=int, default=1)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--clip_gradient_norm", type=float, default=None)
    p.add_argument("--save_every", type=int, default=2500)
    p.add_argument("--eval_every", type=int, default=5000)
    p.add_argument("--max_gt", type=int, default=100)
    p.add_argument("--freeze", type=int, default=2)
    p.add_argument("--flip_prob", type=float, default=0.5)
    p.add_argument("--act_as_obj", action="store_true",
                   help="train/eval on actboxes/actlabels with the "
                        "targetAct2id taxonomy")
    p.add_argument("--bupt_exp", action="store_true",
                   help="targetAct2id_bupt taxonomy + bupt_act_mapping "
                        "(implies --act_as_obj)")
    p.add_argument("--meva_exp", action="store_true",
                   help="targetAct2id_meva taxonomy + meva_act_mapping "
                        "(implies --act_as_obj)")
    args = p.parse_args(argv)
    if args.bupt_exp or args.meva_exp:
        args.act_as_obj = True
    return args


def _act_mapping(args):
    """Classname renames applied before taxonomy lookup (reference
    main.py:825-833)."""
    from .. import class_ids
    if getattr(args, "bupt_exp", False):
        return class_ids.bupt_act_mapping
    if getattr(args, "meva_exp", False):
        return class_ids.meva_act_mapping
    return None


def build_config(args, is_train: bool, device: torch.device
                 ) -> DetectorConfig:
    """The detector configuration the flags name, for ``device``."""
    overrides = dict(
        num_class=args.num_class,
        resnet_depth=50 if args.resnet50 else (
            152 if args.resnet152 else (
                18 if args.resnet18 else (34 if args.resnet34 else 101))),
        short_edge_size=args.short_edge_size, max_size=args.max_size,
        compute_dtype=args.compute_dtype or (
            "bfloat16" if device.type == "cuda" else "float32"),
        is_train=is_train, freeze=args.freeze, add_mask=args.add_mask,
        roi_align_train_impl="pallas")
    remap = {"rpn_batch_size": "rpn_batch_per_im",
             "frcnn_batch_size": "fastrcnn_batch_per_im"}
    for flag in ("use_dilations", "use_deformable", "use_se", "use_resnext",
                 "use_gn", "use_frcnn_class_agnostic", "use_att_frcnn_head",
                 "use_conv_frcnn_head", "add_relation_nn", "focal_loss",
                 "use_small_object_head", "rpn_batch_size",
                 "frcnn_batch_size", "fastrcnn_fg_ratio",
                 "positive_anchor_thres", "negative_anchor_thres",
                 "rpn_test_post_nms_topk", "rpn_train_pre_nms_topk",
                 "rpn_train_post_nms_topk", "fastrcnn_nms_iou_thres",
                 "result_score_thres", "result_per_im"):
        v = getattr(args, flag, None)
        if v is not None:
            overrides[remap.get(flag, flag)] = v
    if args.act_as_obj:
        from .. import class_ids
        table = class_ids.targetAct2id_bupt if args.bupt_exp else (
            class_ids.targetAct2id_meva if args.meva_exp
            else class_ids.targetAct2id)
        cmap = "activity_bupt" if args.bupt_exp else (
            "activity_meva" if args.meva_exp else "activity")
        overrides.update(class_map=cmap, num_class=len(table))
    return DetectorConfig.from_version(args.version, **overrides)


def build(args, is_train: bool, device: torch.device):
    """(config, model on ``device``) for the flags (``build_model``)."""
    cfg = build_config(args, is_train, device)
    return cfg, build_model(args, cfg, device)


def build_model(args, cfg, device: torch.device):
    """The model ``cfg.model`` names, on ``device``: params from seed 0,
    with ``--load_from`` laid over them by ``load_weights`` (names holding
    one of the ':'-separated ``--ignore_vars`` substrings keep their
    init). The flags build a Faster/Mask R-CNN config; EfficientDet is
    trained from a config with ``model="efficientdet"``, as the JAX
    package's quality proof does, through ``build_model`` and ``train``."""
    model = get_model(cfg)
    if args.load_from:
        tree = load_weights(args.load_from, model,
                            ignore_vars=args.ignore_vars)
    else:
        tree = init_params(cfg, seed=0, model_name=cfg.model)
    return params_from_jax(tree, model).to(device)


def checkpoint_dir(args, best=False):
    sub = "best" if best else "save"
    return os.path.abspath(os.path.join(
        args.outbasepath, args.modelname, sub))


def save_ckpt(path, trainer: Trainer, step: int) -> str:
    """The full train state (params, optimizer state, step) as
    ``<path>/step_<step>.pt``."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"step_{step}.pt")
    torch.save(trainer.state_dict(), out)
    return out


def latest_ckpt(path):
    if not os.path.isdir(path):
        return None
    steps = [int(f[len("step_"):-len(".pt")]) for f in os.listdir(path)
             if f.startswith("step_") and f.endswith(".pt")]
    return os.path.join(path, f"step_{max(steps)}.pt") if steps else None


def load_ckpt(path, trainer: Trainer) -> int:
    """Restore ``trainer`` from a checkpoint; returns its step."""
    state = torch.load(path, map_location=trainer.model.device)
    trainer.load_state_dict(state)
    return int(state["step"])


def train_dataset_kwargs(args, cfg) -> dict:
    """The training dataset's options from the flags, beside the samples,
    the class map and the sizes."""
    return dict(
        batch_size=args.im_batch_size, max_gt=args.max_gt,
        flip_prob=args.flip_prob, use_mixup=args.use_mixup,
        with_masks=cfg.add_mask,
        short_edge_jitter=((args.short_edge_size_min,
                            args.short_edge_size_max)
                           if args.scale_jitter else None),
        act_as_obj=args.act_as_obj, act_mapping=_act_mapping(args))


def train_dataset(args, cfg):
    from ..data.training import DetectionTrainDataset
    ds = DetectionTrainDataset(
        args.trainlst, args.framepath, args.annopath, cfg.classname2id,
        cfg.short_edge_size, cfg.max_size,
        **train_dataset_kwargs(args, cfg))
    if args.train_skip > 1:
        ds.samples = ds.samples[::args.train_skip]
        ds.num_samples = len(ds.samples)
    return ds


def run_eval(args, cfg, model, cache=None, dataset=None, mesh=None) -> float:
    """AP/AR of ``model``'s weights on the validation lst, through an
    inference model of the same config (``is_train=False``) on the same
    device, one image per batch and device (the JAX CLI's batch: one image
    per device of its mesh). With ``mesh``, each data rank loads and runs
    its own image of each batch of ``n_data`` alone, unpadded, as the
    one-process eval does; the last batch is padded and its padding
    skipped, so each image is scored once (JAX ``pad_last``,
    ``batch_valid``), and every rank gathers the scored images and
    aggregates them in the val set's order. ``cache`` keeps the inference
    model across periodic evals, and the eval leaves its scored images
    there, ``cache["scored"]``: [(index in the val set, detections, gt)],
    each as ``match_dt_gt`` takes them. ``dataset`` replaces the lst's
    ``DetectionTrainDataset`` with any dataset of its ``batches()``
    interface (with ``mesh``, one of its kind), built as the eval needs
    (batches of one image per data rank, no shuffle or flip)."""
    from ..data.training import DetectionTrainDataset
    from ..evaluation import (aggregate_eval, gather_dt, gather_gt,
                              match_dt_gt, weighted_average)
    n_data = 1 if mesh is None else mesh.n_data
    ds = dataset
    if ds is None:
        ds = DetectionTrainDataset(
            args.vallst, args.valframepath or args.framepath,
            args.valannopath or args.annopath, cfg.classname2id,
            cfg.short_edge_size, cfg.max_size, batch_size=n_data,
            max_gt=args.max_gt, shuffle=False, flip_prob=0.0,
            act_as_obj=args.act_as_obj, act_mapping=_act_mapping(args))
        if args.val_skip > 1:
            ds.samples = ds.samples[::args.val_skip]
            ds.num_samples = len(ds.samples)
    if cache is None:
        cache = {}
    if "model" not in cache:
        cache["model"] = get_model(dataclasses.replace(
            cfg, is_train=False)).to(model.device).eval()
    infer = cache["model"]
    infer.load_state_dict(model.state_dict())

    eval_target = {name: 1 for name in cfg.classname2id if name != "BG"}
    kw = dict(pad_last=True, yield_batch_valid=True)
    if mesh is None:
        first, batches = 0, ds.batches(**kw)
    else:
        from ..parallel.mesh import rank_batches
        first = mesh.data_rank * (ds.batch_size // n_data)
        batches = rank_batches(ds, mesh, whole_shape=False, **kw)
    scored = []   # (index in the val set, dt, gt) of the images run here
    for s, (images, gt_boxes, gt_labels, gt_valid, batch_valid) in \
            enumerate(batches):
        if not batch_valid.any():    # this rank's row is padding
            continue
        out = infer(torch.from_numpy(images).to(model.device))
        out = {k: out[k].cpu().numpy() for k in (
            "final_boxes", "final_probs", "final_labels", "final_valid")}
        for bi in range(images.shape[0]):
            if not batch_valid[bi]:
                continue
            valid = out["final_valid"][bi]
            dt = gather_dt(out["final_boxes"][bi][valid],
                           out["final_probs"][bi][valid],
                           out["final_labels"][bi][valid],
                           eval_target, cfg.classid2name)
            gvalid = gt_valid[bi]
            gt = gather_gt(gt_boxes[bi][gvalid], gt_labels[bi][gvalid],
                           eval_target, cfg.classid2name)
            scored.append((s * ds.batch_size + first + bi, dt, gt))
    if mesh is not None:
        import torch.distributed as dist
        parts = [None] * n_data
        dist.all_gather_object(parts, scored, group=mesh.data_group)
        scored = sorted((t for p in parts for t in p), key=lambda t: t[0])
    e = {c: {} for c in eval_target}
    for img_id, (_, dt, gt) in enumerate(scored):
        match_dt_gt(e, img_id, dt, gt, eval_target)
    cache["scored"] = scored
    present = {c for c in e
               if any(v["gt_num"] > 0 for v in e[c].values())}
    e = {c: v for c, v in e.items() if c in present}
    if not e:
        print("eval: no gt instances in the val set")
        return 0.0
    aps, ars = aggregate_eval(e)
    ap, ar = weighted_average(aps, ars)
    print("eval AP: %.4f AR: %.4f (%s)" % (
        ap, ar, {k: round(v, 3) for k, v in aps.items()}))
    return ap


def train(args, cfg, model, ds, log_every: int = 100, mesh=None):
    """The training loop over ``ds.batches(args.num_epochs)``: resume from
    the latest checkpoint under ``checkpoint_dir(args)``, periodic
    checkpoints and evals, the BN calibration of a model that has
    ``calibrate_bn`` (EfficientDet), a final checkpoint and ``final.npz``.
    Each step's
    random subsamples come from a generator on the model's device seeded
    with the step number, so a resumed run draws what an uninterrupted one
    does. With ``mesh`` (parallel/mesh.py) every rank loads its rows of
    each batch (``rank_batches``) and steps through
    ``make_sharded_train_step`` on them, the evals are sharded over the
    ranks, and rank 0 alone prints and writes the checkpoints and
    ``final.npz``; every rank resumes from the same checkpoint. Returns
    {"losses": total loss per step run, "step", "best_ap", "trainer"}."""
    device = model.device
    main_rank = mesh is None or mesh.rank == 0
    steps_per_epoch = max(1, ds.num_samples // args.im_batch_size)
    total_steps = steps_per_epoch * args.num_epochs
    if args.num_step:
        total_steps = min(total_steps, args.num_step)
    if main_rank:
        print(f"{ds.num_samples} samples, {total_steps} steps")
    tcfg = TrainConfig(
        optimizer=args.optimizer, init_lr=args.init_lr, wd=args.wd,
        momentum=args.momentum, lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, warmup_init_lr=args.init_lr / 10,
        total_steps=total_steps,
        clip_gradient_norm=args.clip_gradient_norm)
    if mesh is None:
        trainer = Trainer(model, tcfg)
        step_fn = trainer.step
        batches = ds.batches(args.num_epochs)
    else:
        from ..parallel.mesh import make_sharded_train_step, rank_batches
        trainer, sharded = make_sharded_train_step(model, tcfg, mesh)
        step_fn = functools.partial(sharded, rows_only=True)
        batches = rank_batches(ds, mesh, args.num_epochs)
    step = 0
    latest = latest_ckpt(checkpoint_dir(args))
    if latest:
        step = load_ckpt(latest, trainer)
        if main_rank:
            print(f"resumed from {latest} (step {step})")

    def tensor(x):
        t = torch.from_numpy(np.ascontiguousarray(x))
        # the sharded step moves the rank's rows to its device
        return t if mesh is not None else t.to(device)

    generator = torch.Generator(device=device)
    loss_ma = deque(maxlen=400)
    totals = []
    best_ap = -1.0
    eval_cache = {}
    t0 = time.time()
    for batch in batches:
        if step >= total_steps:
            break
        images, gt_boxes, gt_labels, gt_valid = [tensor(x)
                                                 for x in batch[:4]]
        gt_masks = tensor(batch[4]) if cfg.add_mask else None
        generator.manual_seed(step)
        losses = step_fn(images, gt_boxes, gt_labels, gt_valid, gt_masks,
                         generator=generator)
        step += 1
        totals.append(float(losses["total_loss"]))
        loss_ma.append(totals[-1])
        if step % log_every == 0 and main_rank:
            print("step %d/%d loss(ma) %.4f %.2f steps/s" % (
                step, total_steps, np.mean(loss_ma),
                log_every / max(time.time() - t0, 1e-6)))
            t0 = time.time()
        if step % args.save_every == 0 and main_rank:
            save_ckpt(checkpoint_dir(args), trainer, step)
        if args.vallst and step % args.eval_every == 0 and \
                not (args.skip_first_eval and step == args.eval_every):
            ap = run_eval(args, cfg, model, cache=eval_cache, mesh=mesh)
            if ap > best_ap:
                best_ap = ap
                if main_rank:
                    save_ckpt(checkpoint_dir(args, best=True), trainer, step)
    if mesh is not None:
        batches.close()   # rank_batches gives the dataset its loader back
    if hasattr(model, "calibrate_bn"):
        # EfficientDet trains with batch-statistics BN: write the
        # precise-BN population statistics before the final checkpoint
        # and final.npz, so that both serve inference (every rank
        # calibrates on the same batches and stays equal)
        model.calibrate_bn(b[0] for b in ds.batches(1))
    if main_rank:
        save_ckpt(checkpoint_dir(args), trainer, step)
        save_npz_tree(os.path.join(args.outbasepath, args.modelname,
                                   "final.npz"), params_to_jax(model))
        print("done; best AP", best_ap)
    return {"losses": totals, "step": step, "best_ap": best_ap,
            "trainer": trainer}


def mode_train(args, dataset=None):
    """Build the model on ``--device`` and train it on ``dataset`` (by
    default the ``DetectionTrainDataset`` the flags name). Under
    ``torchrun`` (also with one process) it trains data-parallel over the
    launched ranks (JAX: always over its mesh): NCCL and the rank's card
    (``cuda:LOCAL_RANK``) with ``--device cuda``, gloo with ``--device
    cpu``; ``--im_batch_size`` is the global batch and must divide over the
    ranks."""
    device = resolve_device(args.device)
    mesh = None
    if launched_by_torchrun():
        from ..parallel.mesh import init_distributed, make_mesh
        device = init_distributed(device.type)
        mesh = make_mesh(n_model=1, device=device)
    cfg, model = build(args, is_train=True, device=device)
    ds = dataset if dataset is not None else train_dataset(args, cfg)
    return train(args, cfg, model, ds, mesh=mesh)


def mode_test(args) -> float:
    """AP of ``--load_from`` on the validation lst (JAX main.py:407-417):
    an ``.npz`` through ``load_weights``, else this driver's
    ``step_<N>.pt``; the seeded init without ``--load_from``."""
    device = resolve_device(args.device)
    cfg = build_config(args, is_train=False, device=device)
    model = get_model(cfg)
    npz = bool(args.load_from) and args.load_from.endswith(".npz")
    tree = load_weights(args.load_from, model) if npz else init_params(
        cfg, seed=0, model_name=cfg.model)
    params_from_jax(tree, model).to(device)
    if args.load_from and not npz:
        model.load_state_dict(torch.load(
            args.load_from, map_location=device)["params"])
    return run_eval(args, cfg, model)


def main(argv=None):
    args = get_args(argv)
    if args.mode == "train":
        mode_train(args)
    elif args.mode == "test":
        mode_test(args)
    elif args.mode == "pack":
        raise NotImplementedError(
            "main.py pack is not ported yet: the counterpart of the JAX "
            "package's runtime/aot.py waits for a captured CUDA graph "
            "(ROADMAP A12)")
    else:
        print("forward mode: use cli.obj_detect_imgs (same output format)",
              file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
