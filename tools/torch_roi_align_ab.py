#!/usr/bin/env python3
"""Time ROIAlign kernel sources against each other, in turns, on one CUDA
GPU: the port's object_detection_tracking_tpu_torch/csrc/roi_align.cu
first, then each source named on the command line (for example an earlier
version of it, unpacked into a git-ignored directory). Every source must
export the same C function, ``roi_align_forward``.

    python3 tools/torch_roi_align_ab.py OTHER.cu [OTHER2.cu ...]

The launches, all bf16 with C=256:
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


def load(src, stem):
    """roi_align_forward of ``src``, built by native.py's nvcc command."""
    from object_detection_tracking_tpu_torch import native
    from object_detection_tracking_tpu_torch.ops import roi_align as RA
    path = native.build_shared(
        os.path.abspath(src), [native.cuda_tool("nvcc")] + native.NVCC_FLAGS,
        stem)
    fn = ctypes.CDLL(path).roi_align_forward
    fn.argtypes = RA._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("torch_roi_align_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
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
