#!/usr/bin/env python3
"""Time ROIAlign kernel sources against each other, in turns, on one CUDA
GPU: the port's object_detection_tracking_tpu_torch/csrc/roi_align.cu
first, then each source named on the command line (for example an earlier
version of it, unpacked into a git-ignored directory).

    python3 tools/torch_roi_align_ab.py OTHER.cu [OTHER2.cu ...]
    python3 tools/torch_roi_align_ab.py --backward OTHER.cu [...]
    python3 tools/torch_roi_align_ab.py --box-grad OTHER.cu [...]

The forward (default; every source exports ``roi_align_forward``: with up
to five levels and a level count, as the port's today, or with exactly
four, as before EfficientDet's mode; the tool calls either). The launches, all bf16 with C=256:
  * the ActEV path's three, on one forward's own inputs (R101-FPN v4 at
    1920x1080 with masks, B=8, chip_smoke.py's random weights for phase 7):
    N=1000 P=7 (proposals), N=100 P=7 (final boxes), N=100 P=14 (masks);
  * chip_smoke.py's phase-3 R50 720p cases, N=1000 and N=100, P=7.
First the host wall of one synchronized ActEV forward through each
source (median of 9, in turns). Then, for each launch and source:
max |kernel - plain|, held to chip_smoke.py's
bound; the median CUDA-event time of the wrapper's call (15 calls,
sources in turns); the kernel's own device time (torch.profiler, mean of
15 calls, taken in the order A B .. B A and averaged); the launch's bound
(chip_smoke.py roi_bound_ms); and the sum of the valid boxes' own windows
(chip_smoke.py roi_windows), the least that a kernel which shares nothing
between boxes gathers. Prints a line per launch and source, then the
results as one JSON line, also written to chiprun_out/roi_align_ab.json.

``--backward``: the ROIAlign backward (B1b, ``roi_align_backward``) on a
training step's own two launches (chip_smoke.py phase 9's R101-FPN v4
model and batch at 1920x1080, B=2, bf16: the box head's N=512 P=7 and the
mask head's fg rows at P=14, read off one forward_train's autograd
graph). The port's source runs through its wrapper; every other source
must export the float32-workspace entry of the port's first B1b (git
8962198: ``roi_align_backward(workspace, out, ...)``) and runs through a
copy of that version's wrapper. For each launch and source: max |kernel -
plain| against autograd of the plain ROIAlign, held to chip_smoke.py's
B1B_REL (plus one bf16 step); the wrapper's median CUDA-event time; the
kernels' device time (torch.profiler, mean of 15 calls, sources in the
order A B .. B A and averaged), by kernel; the bound (chip_smoke.py
roi_bwd_bound_ms). Then the results as one JSON line.

``--box-grad``: ROIAlign's box gradient (B1e, ``roi_align_box_grad``,
the same C entry in every source) on chip_smoke.py phase 17(b)'s SO
launch's own inputs (main.py train --use_small_object_head, R101-FPN v4
at 1920x1080, B=2, bf16 features, float32 grad_out [2,300,7,7,256]: the
phase itself runs, its three kernel checks replaced by a capture). A
variant of the port's design is a throwaway copy of its source. Each
source runs through the port's wrapper. First, at phase 3's synthetic
cases (chip_smoke.py B1E_CASES: every path of the design, bf16 features),
each source against the plain version as below and its device time
(torch.profiler, 15 calls, A B .. B A). Then, on the SO launch, for each
source: max |kernel - plain| on bf16 and
float32 features, held to chip_smoke.py's B1E_REL, and two launches bit
for bit; the wrapper's median CUDA-event time (15 calls, sources in
turns); the kernel's device time (torch.profiler, 15 calls, in the order
A B .. B A and averaged); the bound (chip_smoke.py
roi_box_grad_bound_ms). Then the wrapper's host time by part (the
argument checks, the output's allocation, the device and stream lookup,
the ctypes launch alone); the wrapper as it is and with torch's launch
context (a device switch and a torch Stream object), by CUDA events in
turns and by host time; and whether the train steps handed B1b and B1e a
contiguous grad_out. Prints a line each, then the results as one JSON
line, also written to chiprun_out/roi_box_grad_ab.json.

Exits 1 if a kernel disagrees with the plain version, 2 without a GPU.
"""

import ctypes
import functools
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402  (blocks any import of JAX)


# roi_align_forward's arguments before five levels: f0..f3, (h, w) x4,
# strides x4, boxes, levels, valid, out, then 5 ints and the stream
FOUR_LEVEL_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [
    ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def load(src, stem):
    """roi_align_forward of ``src``, built by native.py's nvcc command,
    callable with the port's wrapper's arguments (five level slots and a
    count): a four-level source gets the first four of each."""
    from object_detection_tracking_tpu_torch import native
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    path = native.build_shared(
        os.path.abspath(src), [native.cuda_tool("nvcc")] + native.NVCC_FLAGS,
        stem)
    fn = ctypes.CDLL(path).roi_align_forward
    fn.restype = ctypes.c_int
    with open(src) as f:
        if "kMaxLevels" in f.read():
            fn.argtypes = RA._ARGTYPES
            return fn
    fn.argtypes = FOUR_LEVEL_ARGTYPES

    def four_levels(*args):
        ptrs, dims, strides, count = args[:5], args[5:15], args[15:20], \
            args[20]
        if count != 4:
            raise ValueError(f"{src} takes exactly 4 levels, not {count}")
        return fn(*ptrs[:4], *dims[:8], *strides[:4], *args[21:])
    return four_levels


def launch_cases():
    """The ActEV model, its input batch, and (label, feats, strides, boxes,
    valid, pool) of every timed launch."""
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
        out = model(x)
    _, feats, strides, launches = CS.forward_kernel_inputs(model, x, out)
    cases = [(f"actev {label}", feats, strides, boxes, valid, pool)
             for label, boxes, valid, pool in launches]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (1000, 100):
        f, b, v = CS.roi_case(gen, n, torch.bfloat16)
        cases.append((f"r50 N={n} P=7", f, CS.STRIDES, b, v, 7))
    return model, x, cases


def host_wall_ms(fns, reps=9):
    """Median host wall of each fn (which ends synchronized), in turns."""
    import time
    for fn in fns:
        fn()
    walls = [[] for _ in fns]
    for r in range(reps):
        for i in (range(len(fns)) if r % 2 == 0
                  else reversed(range(len(fns)))):
            t0 = time.perf_counter()
            fns[i]()
            walls[i].append(1e3 * (time.perf_counter() - t0))
    return [sorted(w)[len(w) // 2] for w in walls]


def train_launches():
    """The training step's two B1b launches: [(label, feats, boxes,
    strides, pool, grad_out, levels)], read off one bf16 forward_train of
    chip_smoke.py phase 9's model (the train CLI's defaults, random weights
    from seed 0, last BN gammas x0.2) on its batch."""
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
    losses = model.forward_train(*tb[:4], gt_masks=tb[4], generator=gen)
    captured = CS.roi_backward_inputs(losses["total_loss"])
    del model, losses
    return [(f"N={captured[p][1].shape[1]} P={p}", *captured[p][:3], p,
             *captured[p][3:]) for p in sorted(captured)]


# roi_align_backward(workspace, out, 12 ints, boxes, levels, grad_out, 5
# ints, stream) of git 8962198
WORKSPACE_BWD_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 12 + [
    ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def workspace_backward(fn, feats, boxes, strides, pool, grad_out, levels):
    """B1b through a source with the first B1b's C entry: the float32
    workspace, zeroed, scattered into and cast by the kernel (the wrapper
    of git 8962198, ops/roi_align.py multilevel_roi_align_backward_cuda)."""
    import torch
    b, n = boxes.shape[:2]
    c = feats[0].shape[-1]
    dtype = feats[0].dtype
    lvl = levels.to(torch.int32).clamp(0, 3).contiguous()
    sizes = [b * f.shape[1] * f.shape[2] * c for f in feats]
    work = torch.empty(sum(sizes), dtype=torch.float32, device=boxes.device)
    out = work if dtype == torch.float32 else torch.empty(
        sum(sizes), dtype=dtype, device=boxes.device)
    dims = []
    for f in feats:
        dims += [f.shape[1], f.shape[2]]
    err = fn(work.data_ptr(), None if out is work else out.data_ptr(), *dims,
             *[int(s) for s in strides], boxes.data_ptr(), lvl.data_ptr(),
             grad_out.data_ptr(), b, n, c, pool,
             int(dtype == torch.bfloat16),
             torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align_backward: CUDA error {err}")
    return [g.view(f.shape) for g, f in zip(out.split(sizes), feats)]


def main_backward(argv):
    """--backward: B1b of the port's source against each named source."""
    import torch
    from object_detection_tracking_tpu_torch import native
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    native.load_cuda("roi_align")
    others = []
    for i, src in enumerate(argv):
        path = native.build_shared(
            os.path.abspath(src),
            [native.cuda_tool("nvcc")] + native.NVCC_FLAGS,
            f"roi_align_bwd_ab{i}")
        fn = ctypes.CDLL(path).roi_align_backward
        fn.argtypes = WORKSPACE_BWD_ARGTYPES
        fn.restype = ctypes.c_int
        others.append(fn)
    sources = [os.path.join("object_detection_tracking_tpu_torch",
                            native.CUDA_SOURCES["roi_align"])] + [
        os.path.relpath(os.path.abspath(a), ROOT) for a in argv]
    card = CS.card_line()
    print(f"[ab] {card}; torch {torch.__version__}", flush=True)
    for stem, text in native.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ab]   {stem}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # each source's kernels, by part (the first B1b's names, then the
    # port's)
    parts = [{"plan": "roi_bwd_plan", "tiles": "roi_align_bwd_tile"}
             ] + [{"zero": "Memset", "scatter": "roi_align_bwd_kernel",
                   "cast": "cast_bf16"}] * len(others)
    results, ok = [], True
    for label, feats, boxes, strides, pool, grad_out, levels in \
            train_launches():
        calls = [functools.partial(RA.multilevel_roi_align_backward_cuda,
                                   feats, boxes, strides, pool, grad_out,
                                   levels)] + [
            functools.partial(workspace_backward, fn, feats, boxes, strides,
                              pool, grad_out, levels) for fn in others]
        ref = RA.multilevel_roi_align_vjp(feats, boxes, strides, pool,
                                          grad_out, levels)
        errs = []
        for call in calls:
            err, fine = 0.0, True
            for g, r in zip(call(), ref):
                g, r = g.float(), r.float()
                d = (g - r).abs()
                fine &= bool((d <= CS.B1B_REL * r.abs().max()
                              + 2.0 ** -7 * r.abs()).all())
                err = max(err, d.max().item())
            errs.append(err)
            ok &= fine
        del ref
        events = CS.median_ms(calls)
        dev = [dict.fromkeys(p, 0.0) for p in parts]
        for i in list(range(len(calls))) + list(reversed(range(len(calls)))):
            for k, v in CS.device_ms(calls[i], parts[i], runs=15).items():
                dev[i][k] += v / 2
        bound_ms = CS.roi_bwd_bound_ms(feats, boxes, strides, pool)
        for src, err, ev, d in zip(sources, errs, events, dev):
            total = sum(d.values())
            results.append({"launch": label, "source": src,
                            "max_abs_err": err, "ms": ev, "device_ms": total,
                            "device_by_part": d, "bound_ms": bound_ms})
            print(f"[ab] backward {label} {src}: max |kernel - plain| "
                  f"{err:.3g}, {ev:.4f} ms (CUDA events, median of 15), "
                  f"device {total:.4f} ms (torch.profiler, mean of 15, A B "
                  f".. B A: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                          d.items())
                  + f"), bound {bound_ms:.4f} ms (bytes), "
                  f"{bound_ms / total:.1%} of it", flush=True)
    print(json.dumps({"card": card, "results": results}))
    return 0 if ok else 1


def so_box_grad_launch():
    """chip_smoke.py phase 17(b)'s SO launch of B1e: (feats, boxes,
    strides, pool, grad_out, levels), as that phase hands them to its
    check; and, for every B1b and B1e call of its train steps, (kernel,
    whether its grad_out arrived contiguous)."""
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    got, layouts = {}, []
    real_check = RA._check_grad_args

    def recording(kernel, features, boxes, strides, output_size, grad_out,
                  levels):
        layouts.append((kernel, grad_out.is_contiguous()))
        return real_check(kernel, features, boxes, strides, output_size,
                          grad_out, levels)

    def capture(label, feats, boxes, strides, pool, grad_out, levels,
                phase="so-train"):
        got["args"] = (feats, boxes, strides, pool, grad_out, levels)
        return {}
    checks = CS.check_roi_launch, CS.check_roi_backward, \
        CS.check_roi_box_grad
    CS.check_roi_launch = CS.check_roi_backward = lambda *a, **k: {}
    CS.check_roi_box_grad = capture
    RA._check_grad_args = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            CS.phase_so_train(tmp)
    finally:
        CS.check_roi_launch, CS.check_roi_backward, \
            CS.check_roi_box_grad = checks
        RA._check_grad_args = real_check
    return got["args"], layouts


def host_us(fn, reps=300):
    """Host time per call of ``reps`` calls of fn queued back to back (no
    sync between them), after a warm-up, in microseconds."""
    import time
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


def torch_launch_env(device):
    """The wrappers' launch context before ``_launch_env``: always a
    device switch, and the stream through a torch Stream object."""
    import torch
    return (torch.cuda.device(device),
            torch.cuda.current_stream(device).cuda_stream)


def wrapper_costs(feats, boxes, strides, pool, grad_out, levels):
    """B1e's wrapper as it is and with ``torch_launch_env`` in place of
    ``_launch_env``: CUDA-event ms of each (median of 15, in turns), and
    host microseconds a call of each and of the wrapper's parts (the
    argument checks, the output's allocation, each launch context, the
    ctypes launch alone). Returns ({name: ms}, {name: us})."""
    import torch
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    real = RA._launch_env

    def wrapper(env):
        def run():
            RA._launch_env = env
            try:
                return RA.multilevel_roi_align_box_grad_cuda(
                    feats, boxes, strides, pool, grad_out, levels)
            finally:
                RA._launch_env = real
        return run

    def enter(env):
        def run():
            ctx, stream = env(boxes.device)
            with ctx:
                return stream
        return run
    b, n, c, dtype, g, lvl = RA._check_grad_args(
        "B1e", feats, boxes, strides, pool, grad_out, levels)
    out = torch.empty((b, n, 4), dtype=torch.float32, device=boxes.device)
    fn = RA._cuda_fn("roi_align_box_grad", RA._BOX_ARGTYPES)
    dims = [d for f in feats for d in (f.shape[1], f.shape[2])]
    args = ([f.data_ptr() for f in feats] + dims
            + [int(s) for s in strides]
            + [boxes.data_ptr(), lvl.data_ptr(), g.data_ptr(),
               out.data_ptr(), b, n, c, pool, int(dtype == torch.bfloat16),
               real(boxes.device)[1]])
    wrappers = {"wrapper": wrapper(real),
                "wrapper_torch_env": wrapper(torch_launch_env)}
    ms = dict(zip(wrappers, CS.median_ms(list(wrappers.values()))))
    parts = dict(wrappers, **{
        "checks": lambda: RA._check_grad_args(
            "B1e", feats, boxes, strides, pool, grad_out, levels),
        "output": lambda: torch.empty((b, n, 4), dtype=torch.float32,
                                      device=boxes.device),
        "launch_env": enter(real),
        "torch_launch_env": enter(torch_launch_env),
        "ctypes_launch": lambda: fn(*args),
    })
    return ms, {k: host_us(v) for k, v in parts.items()}


def main_box_grad(argv):
    """--box-grad: B1e of the port's source against each named source."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from object_detection_tracking_tpu_torch import native
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    names = [os.path.join("object_detection_tracking_tpu_torch",
                          native.CUDA_SOURCES["roi_align"])] + [
        os.path.relpath(os.path.abspath(a), ROOT) for a in argv]

    def build(i):
        return native.build_shared(
            os.path.join(ROOT, names[i]),
            [native.cuda_tool("nvcc")] + native.NVCC_FLAGS,
            f"roi_box_grad_ab{i}")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(build, range(len(names))))
    fns = []
    for path in paths:
        fn = ctypes.CDLL(path).roi_align_box_grad
        fn.argtypes = RA._BOX_ARGTYPES
        fn.restype = ctypes.c_int
        fns.append(fn)
    card = CS.card_line()
    print(f"[ab] {card}; torch {torch.__version__}", flush=True)
    for stem, text in sorted(native.build_logs.items()):
        kernel = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            if "box_grad" in kernel and ("registers" in line
                                         or "spill" in line):
                print(f"[ab]   {stem}: {kernel}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    real_fn = RA._cuda_fn

    def through(fn):
        def call(feats, boxes, strides, pool, grad_out, levels):
            RA._cuda_fn = lambda name, argtypes: (
                fn if name == "roi_align_box_grad"
                else real_fn(name, argtypes))
            try:
                return RA.multilevel_roi_align_box_grad_cuda(
                    feats, boxes, strides, pool, grad_out, levels)
            finally:
                RA._cuda_fn = real_fn
        return call
    calls = [through(fn) for fn in fns]

    def check(call, feats, boxes, strides, pool, grad_out, levels):
        """Max |kernel - plain| over the features as given and in
        float32, held to B1E_REL of max |plain|; two launches bit for
        bit."""
        err, fine = 0.0, True
        runs = [feats] + ([[f.float() for f in feats]]
                          if feats[0].dtype != torch.float32 else [])
        for fs in runs:
            got = call(fs, boxes, strides, pool, grad_out, levels)
            ref = RA.multilevel_roi_align_box_vjp(fs, boxes, strides, pool,
                                                  grad_out, levels)
            e = (got - ref).abs().max().item()
            fine &= bool(torch.isfinite(got).all()) and \
                e <= CS.B1E_REL * ref.abs().max().item()
            fine &= torch.equal(got.view(torch.int32), call(
                fs, boxes, strides, pool, grad_out, levels).view(
                    torch.int32))
            err = max(err, e)
        return err, fine

    results, ok = {"synthetic": [], "so_launch": []}, True
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, kind, n, pool, c, off16 in CS.B1E_CASES:
        feats, boxes, grad_out = CS.box_grad_case(gen, kind, n, c,
                                                  torch.bfloat16, off16)
        g = grad_out(pool)
        levels = RA.fpn_map_rois_to_levels(boxes)
        args = (feats, boxes, CS.STRIDES, pool, g, levels)
        checked = [check(call, *args) for call in calls]
        dev = [0.0] * len(calls)
        for i in list(range(len(calls))) + list(reversed(range(len(calls)))):
            dev[i] += CS.device_ms(functools.partial(calls[i], *args),
                                   {"grad": "roi_align_box_grad"},
                                   runs=15)["grad"] / 2
        for name, (err, fine), d in zip(names, checked, dev):
            ok &= fine
            results["synthetic"].append({"case": label, "source": name,
                                         "max_abs_err": err, "ok": fine,
                                         "device_ms": d})
            print(f"[ab] box-grad synthetic {label} {name}: max |kernel - "
                  f"plain| {err:.3g} ({'ok' if fine else 'FAILED'}), device "
                  f"{d:.4f} ms (torch.profiler, mean of 15, A B .. B A)",
                  flush=True)
        del feats, boxes, g, args
    torch.cuda.empty_cache()
    if not ok:
        print(json.dumps({"card": card, "results": results}))
        return 1

    (feats, boxes, strides, pool, grad_out, levels), layouts = \
        so_box_grad_launch()
    torch.cuda.empty_cache()
    label = f"SO launch N={boxes.shape[1]} P={pool}"
    bound_ms, bound_by = CS.roi_box_grad_bound_ms(feats, boxes, strides,
                                                  pool, levels)
    args = (feats, boxes, strides, pool, grad_out, levels)
    errs = []
    for name, call in zip(names, calls):
        err, fine = check(call, *args)
        ok &= fine
        errs.append((err, fine))
    timed = [functools.partial(call, *args) for call in calls]
    events = CS.median_ms(timed)
    dev = [0.0] * len(timed)
    for i in list(range(len(timed))) + list(reversed(range(len(timed)))):
        dev[i] += CS.device_ms(timed[i], {"grad": "roi_align_box_grad"},
                               runs=15)["grad"] / 2
    for name, (err, fine), ev, d in zip(names, errs, events, dev):
        results["so_launch"].append({
            "launch": label, "source": name, "max_abs_err": err, "ok": fine,
            "ms": ev, "device_ms": d, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / d})
        print(f"[ab] box-grad {label} {name}: max |kernel - plain| "
              f"{err:.3g} ({'ok' if fine else 'FAILED'}; bf16 and f32 "
              f"features, bound {CS.B1E_REL} x max |plain|, bitwise "
              f"repeat), {ev:.4f} ms (CUDA events, median of 15), device "
              f"{d:.4f} ms (torch.profiler, mean of 15, A B .. B A), bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / d:.1%} of it",
              flush=True)
    wrapper_ms, host = wrapper_costs(*args)
    contiguous = {k: sorted({c for kk, c in layouts if kk == k})
                  for k in sorted({k for k, _ in layouts})}
    print(f"[ab] box-grad {label}: the port's wrapper with its launch "
          f"context / with torch's (a device switch and a Stream object): "
          f"{wrapper_ms['wrapper']:.4f} / "
          f"{wrapper_ms['wrapper_torch_env']:.4f} ms (CUDA events, median "
          f"of 15, in turns); host us a call (300 queued back to back): "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
          + f"; grad_out contiguous on arrival in the train steps: "
          f"{contiguous}", flush=True)
    line = json.dumps({"card": card, "results": results,
                       "wrapper_ms": wrapper_ms, "host_us": host,
                       "grad_out_contiguous": contiguous})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "roi_box_grad_ab.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    return 0 if ok else 1


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("torch_roi_align_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    if argv[:1] == ["--backward"]:
        return main_backward(argv[1:])
    if argv[:1] == ["--box-grad"]:
        return main_box_grad(argv[1:])
    from object_detection_tracking_tpu_torch import native
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    sources = [os.path.join(ROOT, "object_detection_tracking_tpu_torch",
                            native.CUDA_SOURCES["roi_align"])] + argv
    fns = [load(src, f"roi_align_ab{i}") for i, src in enumerate(sources)]
    card = CS.card_line()
    print(f"[ab] {card}; torch {torch.__version__}", flush=True)
    for stem, text in native.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ab]   {stem}: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    real = RA._cuda_lib

    def with_lib(fn, work):
        RA._cuda_lib = lambda: fn
        try:
            return work()
        finally:
            RA._cuda_lib = real

    def call(fn, feats, strides, boxes, valid, pool):
        return with_lib(fn, lambda: RA.multilevel_roi_align_cuda(
            feats, boxes, strides, pool, valid=valid))

    def forward(fn):
        def run():
            with torch.inference_mode():
                with_lib(fn, lambda: model(x))
            torch.cuda.synchronize()
        return run

    model, x, cases = launch_cases()
    walls = host_wall_ms([forward(fn) for fn in fns])
    for src, wall in zip(sources, walls):
        print(f"[ab] {os.path.relpath(src, ROOT)}: ActEV forward of "
              f"{CS.BATCH} frames {wall:.2f} ms host wall (synchronized, "
              f"median of 9, sources in turns)", flush=True)
    del model
    torch.cuda.empty_cache()
    results, ok = [], True
    for label, feats, strides, boxes, valid, pool in cases:
        calls = [functools.partial(call, fn, feats, strides, boxes, valid,
                                   pool) for fn in fns]
        ref = RA.multilevel_roi_align(feats, boxes, strides, pool,
                                      valid=valid)
        bound = CS.KERNEL_ATOL * max(1.0, ref.abs().max().item())
        errs = [(c() - ref).abs().max().item() for c in calls]
        del ref
        events = CS.median_ms(calls)
        dev = [0.0] * len(calls)
        for i in list(range(len(calls))) + list(reversed(range(len(calls)))):
            dev[i] += CS.roi_device_ms(calls[i]) / 2
        bound_ms = CS.roi_bound_ms(feats, boxes, valid, strides, pool)
        # each valid box's own window, summed over the boxes: what a kernel
        # that reads every window once (and shares nothing between boxes)
        # gathers from L2
        window = sum(int(((r1 - r0 + 1) * (c1 - c0 + 1)).sum().item())
                     for _, _, r0, r1, c0, c1 in CS.roi_windows(
                         feats, boxes, valid, strides, pool))
        window_gb = (window * feats[0].shape[-1] * feats[0].element_size()
                     / 1e9)
        for src, err, ev, d in zip(sources, errs, events, dev):
            ok &= err <= bound
            results.append({"launch": label, "source": os.path.relpath(
                src, ROOT), "max_abs_err": err, "err_bound": bound,
                "ms": ev, "device_ms": d, "bound_ms": bound_ms,
                "window_gb": window_gb})
            print(f"[ab] {label} ({int(valid.sum())} valid) "
                  f"{os.path.relpath(src, ROOT)}: max |kernel - plain| "
                  f"{err:.3g} (bound {bound:.3g}), {ev:.4f} ms (CUDA events, "
                  f"median of 15), device {d:.4f} ms (torch.profiler, mean "
                  f"of 15), bound {bound_ms:.4f} ms (bytes), "
                  f"{bound_ms / d:.1%} of it; the boxes' own windows "
                  f"{window_gb:.3f} GB, {window_gb / d:.2f} TB/s of them",
                  flush=True)
    for src in sources:
        rel = os.path.relpath(src, ROOT)
        actev = [r for r in results
                 if r["source"] == rel and r["launch"].startswith("actev")]
        print(f"[ab] {rel}: ActEV forward's {len(actev)} launches, device "
              f"{sum(r['device_ms'] for r in actev):.4f} ms, CUDA events "
              f"{sum(r['ms'] for r in actev):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in actev):.4f} ms")
    line = json.dumps({"card": card, "results": results,
                       "forward_wall_ms": dict(zip(
                           [os.path.relpath(s, ROOT) for s in sources],
                           walls))})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "roi_align_ab.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
