#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. The cell
is ``BENCHMARK.json``'s workload ``<name>``; its files are found by name
(``harness/spec.py``). ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer ones, read by ``metrics/<metric>.py`` from the
run's host records and a profiled stretch, with the device's busy and
window seconds and the stretch's ``breakdown``. Every run holds a sample of
the window's outputs against the float32 reference and prints each number
compared beside its limit, as its last lines on standard error and as the
result's last key. It exits non-zero and prints no result without enough
CUDA cards, or if JAX or the JAX package is loaded once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every kernel cache in a fixed directory of the checkout
CACHE = os.path.join(HERE, ".cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "object_detection_tracking_tpu")


def jax_loaded():
    """Modules whose top-level name (before the first dot) is forbidden."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from benchmark.harness import spec, trace as tr
    bench = spec.benchmark(ROOT)
    entry = {w["name"]: w for w in bench["workloads"]}.get(a.workload)
    if entry is None:
        sys.exit(f"no workload {a.workload!r} in BENCHMARK.json")
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        sys.exit(f"needs {entry['chips']} CUDA card(s); "
                 f"cuda available: {torch.cuda.is_available()}")
    files = spec.cell(a.workload)
    if (files["cell"]["config"], files["cell"]["traffic"]) != (
            entry["config"], entry["traffic"]):
        sys.exit(f"{a.workload}: cell file and BENCHMARK.json disagree")
    driver = spec.driver(files["cell"]["driver"])
    res = driver.run(files, a.seed, a.seconds, bool(a.trace), T_START)

    found = jax_loaded()
    if found:
        sys.exit(f"loaded after the window: {', '.join(found)}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"]}
    metrics = {}
    for m in spec.metrics_of(bench, a.workload, bool(a.trace)):
        if a.trace:
            v = spec.reader(m["name"])(res["obs"])
        else:
            v = res.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line["metrics"] = metrics
    rec = res["obs"].get("trace")
    if a.trace and rec and rec["device"]:
        device["busy_s"] = tr.busy_s(rec)
        device["window_s"] = rec["window"][1] - rec["window"][0]
        line["device"] = device
        line["breakdown"] = tr.breakdown(rec)
    else:
        line["device"] = device
    line["checks"] = res["checks"]
    extra = {"compared": res["compared"], "clips": res["clips"],
             "frames": res["obs"]["frames"],
             "window_s": res["obs"]["window_s"],
             "flops_per_frame": res["flops"]["total"],
             "setup_parts": res["setup_parts"],
             "tracked_dets_per_frame": res["tracked_dets_per_frame"],
             "readings": res["readings"], "check_s": res["check_s"],
             "captured": res["captured"]}
    if res["failures"]:
        extra["failures"] = res["failures"]
    print("run: " + json.dumps(extra), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))


if __name__ == "__main__":
    main()
