"""Cold start of the port's packed forward: pack -> a NEW process -> the
first batch (the port's counterpart of tools/pack_coldstart.py).

``cli.main pack`` writes params.npz, config.json, forward.pt2 (the
torch.export graph) and kernels/ (the hand-written kernels' libraries);
``runtime.aot.load_packed`` loads them and captures the forward into one
CUDA graph at its first call. This tool times the first batch in a fresh
python process under three regimes, each with an empty kernel build
directory:

  fresh  the pack without its kernels/: load, nvcc builds the kernels the
         graph launches, first call (warm-up, capture, replay);
  warm   the pack as written: the kernels come from its kernels/ under
         their hashed names, no nvcc;
  live   no pack: the model's Python, --load_from params.npz, nvcc builds
         the kernels at their first launch, the first eager forward.

Then, in each, the median host wall of 5 more synchronized batches.
Usage (on a machine with a CUDA GPU and nvcc):

    python3 tools/torch_pack_coldstart.py [--short_edge_size 1080]
        [--max_size 1920] [--batch 8] [--out coldstart.json]

Prints one JSON line (and writes it to --out): the pack's wall and the
three regimes' seconds, with the card's name and power limit.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys, time
t_start = time.perf_counter()
sys.modules["jax"] = None
import numpy as np
import torch
from object_detection_tracking_tpu_torch import native
regime, pack_dir, build_dir, flags = sys.argv[1:5]
native.BUILD_DIR = build_dir
t_import = time.perf_counter() - t_start
with open(os.path.join(pack_dir, "config.json")) as f:
    meta = json.load(f)
x = torch.from_numpy(np.random.RandomState(0).randint(
    0, 255, (meta["pack"]["batch"], meta["short_edge_size"],
             meta["max_size"], 3), np.uint8)).cuda()
t0 = time.perf_counter()
if regime == "live":
    from object_detection_tracking_tpu_torch.cli import main as cli
    args = cli.get_args(json.loads(flags))
    cfg, model = cli.build(args, is_train=False, device=torch.device("cuda"))
    model.eval()
    params = None
    fn = lambda p, images: model(images)
else:
    from object_detection_tracking_tpu_torch.runtime.aot import load_packed
    cfg, params, fn = load_packed(pack_dir, "cuda")
torch.cuda.synchronize()
t_load = time.perf_counter() - t0
t0 = time.perf_counter()
out = fn(params, x)
torch.cuda.synchronize()
t_first = time.perf_counter() - t0
walls = []
for _ in range(5):
    t0 = time.perf_counter()
    fn(params, x)
    torch.cuda.synchronize()
    walls.append(1e3 * (time.perf_counter() - t0))
print(json.dumps({
    "regime": regime, "import_s": t_import, "load_s": t_load,
    "first_batch_s": t_first, "to_first_output_s":
    time.perf_counter() - t_start - sum(walls) / 1e3,
    "next_batch_ms": sorted(walls)[2],
    "load_split_s": getattr(fn, "load_seconds", None),
    "nvcc_built": sorted(native.build_logs),
    "libraries": native.lib_paths,
    "valid": int(out["final_valid"].sum())}))
"""


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--short_edge_size", type=int, default=1080)
    ap.add_argument("--max_size", type=int, default=1920)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        flags = ["--add_mask", "--im_batch_size", str(a.batch),
                 "--short_edge_size", str(a.short_edge_size), "--max_size",
                 str(a.max_size), "--device", "cuda"]
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "object_detection_tracking_tpu_torch.cli."
             "main", "pack", "--outbasepath", tmp, "--modelname", "cold",
             *flags], check=True, env=env, cwd=ROOT, timeout=1800)
        pack_s = time.perf_counter() - t0
        pack_dir = os.path.join(tmp, "cold", "packed")
        bare = os.path.join(tmp, "bare")          # the pack without kernels
        os.makedirs(os.path.join(bare, "kernels"))
        for name in ("params.npz", "forward.pt2", "config.json"):
            os.symlink(os.path.join(pack_dir, name), os.path.join(bare, name))
        live_flags = ["pack", *flags, "--load_from",
                      os.path.join(pack_dir, "params.npz")]
        regimes = {}
        for regime, where in (("fresh", bare), ("warm", pack_dir),
                              ("live", pack_dir)):
            build = tempfile.mkdtemp(dir=tmp)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, regime, where, build,
                 json.dumps(live_flags)], capture_output=True, text=True,
                env=env, cwd=ROOT, timeout=1800)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            regimes[regime] = dict(json.loads(
                proc.stdout.strip().splitlines()[-1]), process_wall_s=wall)
            shutil.rmtree(build)
    result = {"card": card_line(), "torch": torch.__version__,
              "shape": [a.batch, a.short_edge_size, a.max_size, 3],
              "pack_s": pack_s, "regimes": regimes}
    line = json.dumps(result)
    print(line)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
