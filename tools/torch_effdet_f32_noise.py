#!/usr/bin/env python3
"""How far float32 rounding moves the gradients that chip_smoke.py's
phase 11 holds card against CPU, on one CUDA GPU.

    python3 tools/torch_effdet_f32_noise.py [--warmup-steps 2]

The tree is phase 11's own: chip_smoke.py ``phase_effdet_train`` trains
EfficientDet-d0 on its batch and profiles train steps, and the weights it
leaves go to ``effdet_f32_check``, which this tool takes over.
``--warmup-steps`` is the number of train steps in the step profile's
warm-up (chip_smoke.py runs 2; with 1 the tree is one Adam step short).
On that tree, one f32 ``forward_train`` + backward at B=2 (TF32 off) runs:
  * on the card, twice (how far the card repeats itself);
  * on the CPU in float32, and in float64 (every tensor, the BN
    statistics too: the reference);
  * on the card and on the CPU with the BN statistics' sums taken in
    float64 (E[x^2] - mean^2 as JAX writes it, rounded to float32 after),
    and on the card with a two-pass float32 variance.
For each run against the CPU's float32 (phase 11's comparison) and
against float64: each gradient leaf's max |diff| over its max |ref|, the
worst leaf, the median, and the leaf that phase 11 failed on once
(``fpn_cells/cell_1/fnode2/wsm``). Phase 11's invariant leaves are left
out, as there. Prints a line per run, then the results as one JSON line,
also written to chiprun_out/effdet_f32_noise.json.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402  (blocks any import of JAX)

LEAF = "fpn_cells/cell_1/fnode2/wsm"


def phase11_tree(warmup_steps):
    """(cfg, tree, batch) that phase 11 hands its f32 check."""
    got = []
    profiled = CS.profiled

    def must_profile(fn, runs, phase):
        prof = profiled(fn, runs, warmup=warmup_steps)
        if prof is None:
            raise AssertionError(f"{phase}: no device time")
        return prof
    CS.must_profile = must_profile
    CS.effdet_f32_check = lambda cfg, tree, batch: got.append(
        (cfg, tree, batch)) or {}
    with tempfile.TemporaryDirectory() as tmp:
        CS.phase_effdet_train(tmp)
    return got[0]


def stats_sums64(x):
    """``norm.batch_stats`` with its sums in float64, rounded after."""
    dims = (0,) + tuple(range(2, x.dim()))
    xd = x.double()
    mu = xd.mean(dims)
    return mu.float(), (xd.square().mean(dims) - mu.square()).float()


def stats_two_pass(x):
    """``norm.batch_stats`` with a two-pass float32 variance."""
    dims = (0,) + tuple(range(2, x.dim()))
    xf = x.float()
    mu = xf.mean(dims)
    centred = xf - mu.view((1, -1) + (1,) * (x.dim() - 2))
    return mu, centred.square().mean(dims)


@contextlib.contextmanager
def patched(stats=None, f64=False):
    """BN statistics replaced by ``stats``; with ``f64``, every
    ``Tensor.float()`` of the model's code gives float64 instead."""
    import torch
    from object_detection_tracking_tpu_torch.ops import norm
    saved = norm.batch_stats, torch.Tensor.float
    if stats is not None:
        norm.batch_stats = stats
    if f64:
        torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        norm.batch_stats, torch.Tensor.float = saved


def gradients(cfg, tree, batch, device, stats=None, f64=False):
    import torch
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import (_leaves,
                                                            params_from_jax)
    c = dataclasses.replace(cfg, compute_dtype="float64" if f64
                            else "float32")
    model = params_from_jax(tree, get_model(c)).to(device)
    if f64:
        model = model.double()
    tb = [torch.from_numpy(x[:CS.EFFDET_F32_BATCH]).to(device)
          for x in batch[:4]]
    with patched(stats, f64):
        losses = model.forward_train(*tb)
        losses["total_loss"].backward()
    return {"/".join(p): (t.grad if t.grad is not None
                          else torch.zeros_like(t)).detach().cpu().double()
            for p, t, _ in _leaves(model)}


def summary(got, ref, keys):
    shares = {}
    for k in keys:
        scale = ref[k].abs().max().item()
        shares[k] = ((got[k] - ref[k]).abs().max().item() / scale
                     if scale else 0.0)
    worst = max(shares, key=shares.get)
    return {"max": shares[worst], "worst": worst,
            "median": sorted(shares.values())[len(shares) // 2],
            "leaf": shares[LEAF]}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup-steps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tree, batch = phase11_tree(args.warmup_steps)
    grads = lambda dev, **kw: gradients(cfg, tree, batch, dev, **kw)  # noqa
    ref = grads("cpu", f64=True)
    cpu = grads("cpu")
    keys = [k for k in ref if not CS.INVARIANT_LEAF.search(k)]
    runs = {"card": grads("cuda"), "card_again": grads("cuda"),
            "cpu_f32": cpu,
            "card_bn_sums_f64": grads("cuda", stats=stats_sums64),
            "cpu_bn_sums_f64": grads("cpu", stats=stats_sums64),
            "card_bn_two_pass": grads("cuda", stats=stats_two_pass)}
    out = {"card": CS.card_line(), "warmup_steps": args.warmup_steps,
           "card_vs_card": summary(runs["card_again"], runs["card"], keys)}
    for name, g in runs.items():
        out[name] = {"vs_f64": summary(g, ref, keys)}
        if name != "cpu_f32":
            out[name]["vs_cpu_f32"] = summary(g, cpu, keys)
        print(name, json.dumps(out[name]), flush=True)
    print("card_vs_card", json.dumps(out["card_vs_card"]))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "effdet_f32_noise.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
