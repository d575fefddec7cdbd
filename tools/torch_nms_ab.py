#!/usr/bin/env python3
"""Time greedy-NMS kernel sources (kernel N1) against each other, in
turns, on one CUDA GPU: the port's
object_detection_tracking_tpu_torch/csrc/nms.cu first, then each source
named on the command line (for example an earlier version of it, unpacked
into a git-ignored directory), then each source after ``--floor``.

    python3 tools/torch_nms_ab.py OTHER.cu [...] [--floor VARIANT.cu ...]

A source that exports ``nms_plan`` takes the port's C entry and runs
through the port's wrapper (ops/nms.py greedy_keep_cuda). Any other
source must export the two-kernel entry of the first N1 (git 32ff869:
``nms_keep(boxes, valid, keep, mask, ...)``, the suppression bitmask as
scratch) and runs through a copy of that version's wrapper, which
allocates the bitmask on every call. A ``--floor`` source is a variant of
the port's design that skips work (say, the kept rows' tests: the chain
of per-word decisions alone): it is timed beside the others, and its
masks are reported but not required to equal the plain version's.

The launches: chip_smoke.py phase 3's five NMS_CASES (clustered synthetic
boxes at each path's NMS shape, generator seed 7), the ActEV forward's
own two (R101-FPN v4 at 1920x1080 with masks, B=8, chip_smoke.py's random
weights for phase 7: proposals [8,5,1000] at 0.7, predictions [8,15,200]
at 0.5) and the training step's one (chip_smoke.py phase 9's model and
batch, B=2: proposals [2,5,2000] at 0.7), each recorded by chip_smoke.py
record_nms. For each launch and source: whether its keep masks equal the
plain fixpoint's bit for bit; the wrapper's median CUDA-event time (15
calls, sources in turns); the kernels' own device time (torch.profiler,
mean of 15 calls, taken in the order A B .. B A and averaged); the
launch's bound (chip_smoke.py nms_bound_ms) and its share; and the
wrapper's host time by part (the whole wrapper, the output's and the
scratch's allocations, the launch context, the ctypes launch alone; 300
calls queued back to back). Each source's regime (cluster size, CTAs;
its own nms_plan) is printed on each launch's line. Prints a line per
launch and source, then the results as one JSON line, also written to
chiprun_out/nms_ab.json.

Exits 1 if a source other than a ``--floor`` one disagrees with the plain
version, 2 without a GPU.
"""

import ctypes
import functools
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402  (blocks any import of JAX)

# nms_keep(boxes, valid, keep, mask, groups, n, thres, stream) of git 32ff869
SCRATCH_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
    ctypes.c_float, ctypes.c_void_p]


class Source:
    """One kernel source, built by native.py's nvcc command: its wrapper
    call, its kernels by part (the names the profiler records) and its
    host-time parts."""

    def __init__(self, path, stem, floor=False):
        from object_detection_tracking_tpu_torch import native
        from object_detection_tracking_tpu_torch.ops import nms as N
        self.name = os.path.relpath(os.path.abspath(path), ROOT)
        self.floor = floor
        lib = ctypes.CDLL(native.build_shared(
            os.path.abspath(path),
            [native.cuda_tool("nvcc")] + native.NVCC_FLAGS, stem))
        with open(path) as f:
            self.scratch = "nms_plan" not in f.read()
        self.fn = lib.nms_keep
        self.fn.restype = ctypes.c_int
        if self.scratch:
            self.fn.argtypes = SCRATCH_ARGTYPES
            self.parts = {"mask": "nms_mask", "scan": "nms_scan"}
        else:
            self.fn.argtypes = N._ARGTYPES
            lib.nms_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]
            lib.nms_plan.restype = ctypes.c_int
            self.lib = lib
            self.parts = {"keep": CS.NMS_KERNEL}

    def regime(self, valid):
        """This source's launch for ``valid``'s shape, and its text (the
        port's nms_regime, through this source's nms_plan)."""
        from object_detection_tracking_tpu_torch.ops import nms as N
        if self.scratch:
            return None, "a bitmask kernel and one warp a group scanning it"
        real = N._lib
        N._lib = lambda: self.lib
        try:
            return CS.nms_regime(valid)
        finally:
            N._lib = real

    def call(self, boxes, valid, thres):
        """The keep mask through this source's wrapper."""
        from object_detection_tracking_tpu_torch.ops import nms as N
        if self.scratch:
            return scratch_wrapper(self.fn, boxes, valid, thres)
        real = N._lib
        N._lib = lambda: self.lib
        try:
            return N.greedy_keep_cuda(boxes, valid, thres)
        finally:
            N._lib = real

    def host_parts(self, boxes, valid, thres):
        """{part: host microseconds a call} of this source's wrapper."""
        import torch
        from object_detection_tracking_tpu_torch.ops.roi_align import \
            _launch_env
        groups, n = math.prod(valid.shape[:-1]), valid.shape[-1]
        keep = torch.empty((groups, n), dtype=torch.bool,
                           device=boxes.device)
        stream = _launch_env(boxes.device)[1]
        parts = {
            "wrapper": lambda: self.call(boxes, valid, thres),
            "output": lambda: torch.empty((groups, n), dtype=torch.bool,
                                          device=boxes.device),
            "launch_env": lambda: _launch_env(boxes.device)}
        if self.scratch:
            words = -(-n // 64)
            mask = torch.empty((groups, n, words), dtype=torch.int64,
                               device=boxes.device)
            parts["scratch"] = lambda: torch.empty(
                (groups, n, words), dtype=torch.int64, device=boxes.device)
            parts["ctypes_launch"] = lambda: self.fn(
                boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                mask.data_ptr(), groups, n, float(thres), stream)
        else:
            parts["ctypes_launch"] = lambda: self.fn(
                boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), groups,
                n, float(thres), stream)
        return {k: host_us(v) for k, v in parts.items()}


def scratch_wrapper(fn, boxes_sorted, valid_sorted, thres):
    """N1 through a source with the first N1's C entry: the wrapper of git
    32ff869 (ops/nms.py greedy_keep_cuda), which allocates the bitmask
    [groups, n, ceil(n / 64)] int64 on every call."""
    import torch
    from object_detection_tracking_tpu_torch.ops.roi_align import \
        _launch_env
    lead, n = tuple(valid_sorted.shape[:-1]), valid_sorted.shape[-1]
    groups = math.prod(lead)
    boxes = boxes_sorted.reshape(groups, n, 4).contiguous()
    valid = valid_sorted.reshape(groups, n).contiguous()
    keep = torch.empty((groups, n), dtype=torch.bool, device=boxes.device)
    mask = torch.empty((groups, n, -(-n // 64)), dtype=torch.int64,
                       device=boxes.device)
    ctx, stream = _launch_env(boxes.device)
    with ctx:
        err = fn(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                 mask.data_ptr(), groups, n, float(thres), stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    return keep.reshape(*lead, n)


def host_us(fn, reps=300):
    """Host time per call of ``reps`` calls of fn queued back to back (no
    sync between them), after a warm-up, in microseconds."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def actev_launches():
    """The ActEV forward's two NMS launches, [(boxes, valid, thres)]: one
    bf16 forward of chip_smoke.py phase 7's model on a synthetic batch."""
    import numpy as np
    import torch
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        _, cfg, tree = CS.actev_setup(tmp, device)
    model = CS.build_model(cfg, tree, device)
    video = CS.SyntheticVideo(CS.BATCH, seed=1, h=CS.ACTEV_H, w=CS.ACTEV_W)
    x = torch.from_numpy(np.stack([video.read()[1]
                                   for _ in range(CS.BATCH)])).to(device)
    with torch.inference_mode():
        _, seen = CS.record_nms(lambda: model(x))
    del model
    return seen


def train_launches():
    """The training step's NMS launch, [(boxes, valid, thres)]: one bf16
    forward_train of chip_smoke.py phase 9's model (the train CLI's
    defaults, random weights from seed 0, last BN gammas x0.2) on its
    batch."""
    import torch
    from object_detection_tracking_tpu_torch.cli import main as train_cli
    from object_detection_tracking_tpu_torch.models import get_model
    from object_detection_tracking_tpu_torch.params import (init_params,
                                                            params_from_jax)
    device = torch.device("cuda")
    args = train_cli.get_args(["train", "--add_mask", "--im_batch_size",
                               str(CS.TRAIN_BATCH), "--device", "cuda"])
    cfg = train_cli.build_config(args, True, device)
    tree = init_params(cfg, seed=0)
    for gname, group in tree["resnet"].items():   # as chip_smoke.py phase 9
        if gname.startswith("group"):
            for blk in group.values():
                last = blk["conv3"] if "conv3" in blk else blk["conv2"]
                last["bn"]["gamma"] *= 0.2
    model = params_from_jax(tree, get_model(cfg)).to(device)
    tb = [torch.from_numpy(x).to(device)
          for x in CS.train_batch(cfg, args.max_gt)]
    gen = torch.Generator(device=device).manual_seed(1000)
    with torch.no_grad():
        _, seen = CS.record_nms(lambda: model.forward_train(
            *tb[:4], gt_masks=tb[4], generator=gen))
    del model
    return seen


def main(argv):
    from concurrent.futures import ThreadPoolExecutor

    import torch
    if not torch.cuda.is_available():
        print("torch_nms_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    from object_detection_tracking_tpu_torch import native
    from object_detection_tracking_tpu_torch.ops import nms as N
    others, floors = argv, []
    if "--floor" in argv:
        i = argv.index("--floor")
        others, floors = argv[:i], argv[i + 1:]
    paths = [os.path.join(ROOT, "object_detection_tracking_tpu_torch",
                          native.CUDA_SOURCES["nms"])] + others + floors
    with ThreadPoolExecutor(len(paths)) as pool:
        sources = list(pool.map(
            lambda a: Source(a[1], f"nms_ab{a[0]}",
                             floor=a[0] > len(others)),
            enumerate(paths)))
    card = CS.card_line()
    print(f"[ab] {card}; torch {torch.__version__}", flush=True)
    for stem, text in sorted(native.build_logs.items()):
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            if "nms" in kernel and ("registers" in line or "spill" in line):
                print(f"[ab]   {stem}: {kernel}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(7)
    launches = [(f"synthetic {label}", *CS.nms_case(gen, shape), thres)
                for label, shape, thres in CS.NMS_CASES]
    launches += [(f"actev {label}", *launch) for label, launch in zip(
        ("proposals", "predictions"), actev_launches())]
    launches += [("train proposals", *launch) for launch in train_launches()]
    torch.cuda.empty_cache()

    results, ok = [], True
    for label, boxes, valid, thres in launches:
        ref = N.greedy_keep_plain(boxes, valid, thres)
        bound_ms, bound_by = CS.nms_bound_ms(boxes, valid, ref)
        calls = [functools.partial(s.call, boxes, valid, thres)
                 for s in sources]
        equal = [torch.equal(call(), ref) and torch.equal(call(), ref)
                 for call in calls]
        events = CS.median_ms(calls)
        dev = [dict.fromkeys(s.parts, 0.0) for s in sources]
        order = list(range(len(calls)))
        for i in order + order[::-1]:
            for k, v in CS.device_ms(calls[i], sources[i].parts,
                                     runs=15).items():
                dev[i][k] += v / 2
        for s, eq, ev, d in zip(sources, equal, events, dev):
            ok &= eq or s.floor
            total = sum(d.values())
            host = s.host_parts(boxes, valid, thres)
            plan, regime = s.regime(valid)
            results.append({
                "launch": label, "shape": list(valid.shape), "thres": thres,
                "source": s.name, "floor": s.floor, "equal": eq,
                "ms": ev, "device_ms": total, "device_by_part": d,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_share": bound_ms / total, "host_us": host,
                "regime": plan,
                "valid": int(valid.sum().item()),
                "kept": int(ref.sum().item())})
            print(f"[ab] {label} {list(valid.shape)} @{thres} {s.name}"
                  f"{' (floor variant)' if s.floor else ''}"
                  f" ({regime}): keep masks "
                  f"{'equal' if eq else 'NOT equal'} to the plain "
                  f"fixpoint's ({int(ref.sum())} of {int(valid.sum())} "
                  f"kept), {ev:.4f} ms (CUDA events, median of 15), device "
                  f"{total:.4f} ms (torch.profiler, mean of 15, A B .. B A"
                  + "".join(f"; {k} {v:.4f}" for k, v in d.items()
                            if len(d) > 1)
                  + f"), bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{bound_ms / total:.1%} of it; host us a call: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in host.items()),
                  flush=True)
    line = json.dumps({"card": card, "results": results})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "nms_ab.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
