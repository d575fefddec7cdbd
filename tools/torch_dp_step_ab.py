#!/usr/bin/env python3
"""Time the data-parallel train step (parallel/mesh.py
make_sharded_train_step, what ``main.py train`` runs under torchrun)
against the one-process ``Trainer.step`` on one card, in turns, at
chip_smoke phase 9's settings: R101-FPN v4 with the mask head, 1920x1080,
B=2, bf16, freeze=2, seeded weights, one synthetic batch. The process
group is NCCL at world size 1 (MASTER_ADDR/MASTER_PORT set here).

Per step: CUDA-event ms and host wall of each path, ``--pairs`` pairs,
the order alternating; the flat gradient all-reduce that several data
ranks make (one rank skips it), alone; and torch.profiler
over ``--profile`` steps of each path: kernel ms and launches a step, and
the NCCL kernels' share. Prints one JSON line (and writes it to
``--out``).

    python3 tools/torch_dp_step_ab.py [--pairs 20] [--profile 3]
        [--deterministic] [--out chiprun_out/dp_step_ab.json]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def quartiles(v):
    v = sorted(v)
    return [v[len(v) // 4], v[len(v) // 2], v[(3 * len(v)) // 4]]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pairs", type=int, default=20)
    p.add_argument("--profile", type=int, default=3)
    p.add_argument("--deterministic", action="store_true",
                   help="cudnn.deterministic, as chip_smoke phase 19")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import chip_smoke as cs          # blocks jax; the synthetic batch
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from object_detection_tracking_tpu_torch.cli import main as train_cli
    from object_detection_tracking_tpu_torch.config import TrainConfig
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            params_from_jax)
    from object_detection_tracking_tpu_torch.parallel import mesh as par
    from object_detection_tracking_tpu_torch.train import Trainer

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.deterministic = args.deterministic
    os.environ.update(MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(cs.free_port()), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    device = par.init_distributed("cuda")
    try:
        mesh = par.make_mesh(device=device)
        targs = train_cli.get_args(["train", "--add_mask", "--device",
                                    "cuda"])
        cfg = train_cli.build_config(targs, True, device)
        tree = init_params(cfg, seed=0)
        for gname, group in tree["resnet"].items():   # as chip_smoke's
            if gname.startswith("group"):
                for blk in group.values():
                    last = blk["conv3"] if "conv3" in blk else blk["conv2"]
                    last["bn"]["gamma"] *= 0.2
        tcfg = TrainConfig(optimizer="momentum", init_lr=targs.init_lr,
                           wd=targs.wd, momentum=targs.momentum,
                           lr_schedule="constant", warmup_steps=0,
                           total_steps=1000, clip_gradient_norm=10.0)
        models = [params_from_jax(tree, get_model(cfg)).to(device)
                  for _ in range(2)]
        trainer, sharded = par.make_sharded_train_step(models[0], tcfg,
                                                       mesh)
        plain = Trainer(models[1], tcfg).step
        batch = [torch.from_numpy(x).to(device)
                 for x in cs.train_batch(cfg, targs.max_gt,
                                         b=cs.TRAIN_BATCH)]
        gen = torch.Generator(device=device)
        paths = {"sharded": sharded, "one-process": plain}

        def step(name, seed):
            gen.manual_seed(seed)
            paths[name](*batch, generator=gen)

        for name in paths:                  # cuDNN plans, allocator
            for i in range(2):
                step(name, i)
        ms = {k: [] for k in paths}
        wall = {k: [] for k in paths}
        for i in range(args.pairs):
            order = list(paths) if i % 2 == 0 else list(paths)[::-1]
            for name in order:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev[0].record()
                step(name, 100 + i)
                ev[1].record()
                ev[1].synchronize()
                wall[name].append(1e3 * (time.perf_counter() - t0))
                ms[name].append(ev[0].elapsed_time(ev[1]))
        params = list(trainer.opt.params.values())
        ar = []
        for _ in range(20):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            flat = torch.cat([x.grad.reshape(-1) for x in params])
            dist.all_reduce(flat, group=mesh.data_group)
            ev[1].record()
            ev[1].synchronize()
            ar.append(ev[0].elapsed_time(ev[1]))
        prof = {}
        for name in paths:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as pr:
                for i in range(args.profile):
                    step(name, 200 + i)
                torch.cuda.synchronize()
            events = [e for e in cs._cuda_events(pr)
                      if e.self_device_time_total > 0]
            total = sum(e.self_device_time_total for e in events) / 1e3
            nccl = sum(e.self_device_time_total for e in events
                       if "nccl" in e.key.lower()) / 1e3
            prof[name] = {
                "kernel_ms": total / args.profile,
                "nccl_ms": nccl / args.profile,
                "launches": sum(e.count for e in events) // args.profile}
        res = {
            "card": cs.card_line(), "torch": torch.__version__,
            "cudnn_deterministic": args.deterministic,
            "pairs": args.pairs, "grad_elements": sum(
                x.numel() for x in params),
            "ms_quartiles": {k: quartiles(v) for k, v in ms.items()},
            "wall_quartiles": {k: quartiles(v) for k, v in wall.items()},
            "sharded_slower_pairs": sum(a > b for a, b in zip(
                ms["sharded"], ms["one-process"])),
            "all_reduce_ms_quartiles": quartiles(ar),
            "profile": prof}
        line = json.dumps(res)
        print(line)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
