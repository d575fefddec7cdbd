#!/usr/bin/env python3
"""Data-parallel training and eval over several cards of one host, one
process a card, as ``torchrun --nproc_per_node N -m
object_detection_tracking_tpu_torch.cli.main train`` runs them: the
quality proof's R18-FPN at 160 px (numpy scenes in memory, float32, TF32
off, flips on) for ``--steps`` steps of a global batch of 8, each rank
decoding its rows alone (``parallel/mesh.py rank_batches``), against the
same run in one process on the first card:

- every rank ends with the same parameters, bit for bit (checked);
- their largest gap to the one-process run's parameters, as a share of
  that leaf's largest update (reported: the sums run in another order);
- the sharded eval (``run_eval(mesh=)``, one image a rank at a time) of
  the one-process run's weights scores every val image once, with the
  one-process eval's detections and AP (checked);
- ms a step after the run, ``--timed`` further steps (the median,
  synchronized host wall), one card at the global batch against the
  ranks at their share of it.

Prints one JSON line (and writes it to ``--out``); exits 1 when a check
fails. ``--device cpu`` runs the ranks on gloo instead (a rehearsal at a
small size).

    python3 tools/torch_dp_cards.py [--ranks N] [--steps 6]
        [--device cuda|cpu] [--out chiprun_out/dp_cards.json]
"""

import argparse
import json
import os
import shutil
import socket
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def setup(opts, device):
    """(train args, config, model, train dataset, val scenes) of the run:
    the quality proof's flags and scenes at ``opts``' size."""
    from object_detection_tracking_tpu_torch.cli import main as driver
    from object_detection_tracking_tpu_torch.cli import quality_proof as Q
    from object_detection_tracking_tpu_torch.data.synthetic_np import \
        MemoryDetectionDataset
    qargs = Q.get_args(["--workdir", opts["workdir"], "--train_images",
                        str(opts["train_images"]), "--val_images",
                        str(opts["val_images"]), "--image_size",
                        str(opts["image_size"]), "--steps",
                        str(opts["steps"]), "--batch_size", "8",
                        "--device", opts["device"]])
    train_scenes, val_scenes = Q.render_scenes(qargs)
    train_args = driver.get_args(Q.train_flags(qargs))
    train_args.num_step = opts["steps"]
    cfg = Q.proof_config(qargs, train_args, device)
    model = driver.build_model(train_args, cfg, device)
    ds = MemoryDetectionDataset(
        train_scenes, cfg.classname2id, cfg.short_edge_size, cfg.max_size,
        **driver.train_dataset_kwargs(train_args, cfg))
    return train_args, cfg, model, ds, val_scenes


def evaluate(train_args, cfg, model, val_scenes, mesh=None):
    """(AP, scored images) of ``model`` on the val scenes, one image a
    batch and data rank."""
    from object_detection_tracking_tpu_torch.cli import main as driver
    from object_detection_tracking_tpu_torch.data.synthetic_np import \
        MemoryDetectionDataset
    val = MemoryDetectionDataset(
        val_scenes, cfg.classname2id, cfg.short_edge_size, cfg.max_size,
        batch_size=1 if mesh is None else mesh.n_data, max_gt=8,
        shuffle=False, flip_prob=0.0)
    cache = {}
    ap = driver.run_eval(train_args, cfg, model, cache=cache, dataset=val,
                         mesh=mesh)
    return ap, cache["scored"]


def flat_params(model):
    from object_detection_tracking_tpu_torch.params import _leaves
    return {"/".join(path): t.detach().cpu().clone()
            for path, t, _ in _leaves(model)}


def timed_steps(step, batches, n, device):
    """Median synchronized host ms of ``n`` calls ``step(batch,
    generator)`` on ``batches`` after 2 untimed ones."""
    import torch
    gen = torch.Generator(device=device)
    times = []
    for i, batch in zip(range(n + 2), batches):
        batch = [torch.from_numpy(x) for x in batch]
        gen.manual_seed(10 ** 6 + i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step(batch, gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if i >= 2:
            times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def no_tf32(device):
    import torch
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def rank_main(rank, world, port, opts):
    import torch
    from object_detection_tracking_tpu_torch.cli import main as driver
    from object_detection_tracking_tpu_torch.parallel import mesh as par
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if opts["device"] == "cpu":
        torch.set_num_threads(1)
    device = par.init_distributed(opts["device"], timeout_s=300)
    try:
        no_tf32(device)
        mesh = par.make_mesh(device=device)
        base = opts["workdir"]
        train_args, cfg, model, ds, val_scenes = setup(
            dict(opts, workdir=os.path.join(base, f"rank{rank}")), device)
        t0 = time.perf_counter()
        res = driver.train(train_args, cfg, model, ds, log_every=10 ** 9,
                           mesh=mesh)
        wall = time.perf_counter() - t0
        torch.save(flat_params(model), os.path.join(base,
                                                    f"params{rank}.pt"))
        _, sharded = par.make_sharded_train_step(model, res["trainer"].cfg,
                                                 mesh)
        step_ms = timed_steps(
            lambda b, g: sharded(*b, generator=g, rows_only=True),
            par.rank_batches(ds, mesh, 100), opts["timed"], device)
        model.load_state_dict(torch.load(opts["one_state"],
                                         map_location=device))
        ap, scored = evaluate(train_args, cfg, model, val_scenes, mesh)
        torch.save({"losses": res["losses"], "wall": wall, "ap": ap,
                    "scored": scored, "step_ms": step_ms},
                   os.path.join(base, f"out{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ranks", type=int, default=None,
                   help="default: every card (4 with --device cpu)")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--timed", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from object_detection_tracking_tpu_torch.cli import main as driver

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    world = args.ranks or (torch.cuda.device_count() if cuda else 4)
    small = not cuda   # the CPU rehearsal: fewer, smaller scenes
    tmp = tempfile.mkdtemp(prefix="dp_cards_")
    opts = dict(device=args.device, steps=args.steps, workdir=tmp,
                timed=args.timed,
                train_images=16 if small else 64,
                val_images=5 if small else 11,
                image_size=96 if small else 160)

    # the one-process run on the first card (one thread on the CPU, as
    # each rank: the CPU's sums follow its thread count)
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if not cuda:
        torch.set_num_threads(1)
    no_tf32(device)
    train_args, cfg, model, ds, val_scenes = setup(
        dict(opts, workdir=os.path.join(tmp, "one")), device)
    before = flat_params(model)
    t0 = time.perf_counter()
    res = driver.train(train_args, cfg, model, ds, log_every=10 ** 9)
    one_wall = time.perf_counter() - t0
    one = flat_params(model)
    trainer = res["trainer"]
    one_step_ms = timed_steps(
        lambda b, g: trainer.step(*[x.to(device) for x in b], generator=g),
        ds.batches(100), args.timed, device)
    one_ap, one_scored = evaluate(train_args, cfg, model, val_scenes)
    opts["one_state"] = os.path.join(tmp, "one_state.pt")
    torch.save(model.state_dict(), opts["one_state"])
    del model

    # the ranks; each leaves its params and results in tmp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(rank_main, args=(world, port, opts),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + args.timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{args.timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()
    outs = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]
    params = [torch.load(os.path.join(tmp, f"params{r}.pt"))
              for r in range(world)]

    same = all(torch.equal(params[r][k], params[0][k])
               for r in range(1, world) for k in params[0])
    # the gap to the one-process params: the largest share of a leaf's own
    # largest update, and of the largest update of any leaf
    top = max(float((v - before[k]).abs().max()) for k, v in one.items())
    gap = gap_top = 0.0
    for k, v in one.items():
        step = float((v - before[k]).abs().max())
        d = float((params[0][k] - v).abs().max())
        if d:
            gap = max(gap, d / step if step else float("inf"))
            gap_top = max(gap_top, d / top)
    evals_equal = all(o["scored"] == one_scored and o["ap"] == one_ap
                      for o in outs)
    losses = [o["losses"] for o in outs]
    finite = all(np.isfinite(x).all() for x in losses)
    res_line = {
        "device": args.device, "ranks": world, "steps": args.steps,
        "global_batch": 8, "image_size": opts["image_size"],
        "card": (open_card_line() if cuda else "cpu"),
        "torch": torch.__version__,
        "ranks_bit_equal": same, "largest_gap_of_update": gap,
        "largest_gap_of_top_update": gap_top,
        "losses_one": res["losses"], "losses_ranks": losses[0],
        "eval_images": len(one_scored), "eval_ap": one_ap,
        "sharded_eval_equal": evals_equal,
        "run_wall_s_one": one_wall, "run_wall_s_ranks": [o["wall"]
                                                          for o in outs],
        "step_ms_one": one_step_ms,
        "step_ms_ranks": [o["step_ms"] for o in outs]}
    res_line["ok"] = bool(same and evals_equal and finite)
    line = json.dumps(res_line)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    shutil.rmtree(tmp, ignore_errors=True)
    return 0 if res_line["ok"] else 1


def open_card_line():
    import subprocess
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


if __name__ == "__main__":
    sys.exit(main())
