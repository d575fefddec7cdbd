"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root names the cells; ``workloads/<cell>.json`` names its configuration,
traffic and driver; ``configs/<config>.json``, ``traffic/<traffic>.json``,
``drivers/<driver>.py`` and ``metrics/<metric>.py`` are found by those
names. A new cell, configuration, traffic mix or per-layer metric is a new
file and an entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def cell(name: str, bench_dir: str = BENCH_DIR) -> Dict[str, dict]:
    """The cell ``name``'s own file with its configuration and traffic
    files: {"cell", "config", "traffic"}."""
    c = load_json(bench_dir, "workloads", name + ".json")
    return {"cell": c,
            "config": load_json(bench_dir, "configs", c["config"] + ".json"),
            "traffic": load_json(bench_dir, "traffic",
                                 c["traffic"] + ".json")}


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, bench_dir: str = BENCH_DIR):
    """The driver module ``drivers/<kind>.py`` (its ``run``)."""
    return _module(os.path.join(bench_dir, "drivers", kind + ".py"),
                   "bench_driver_" + kind)


def reader(metric: str, bench_dir: str = BENCH_DIR) -> Callable:
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module(os.path.join(bench_dir, "metrics", metric + ".py"),
                   "bench_metric_" + metric.replace(".", "_")).read


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    (``trace`` False) or its per-layer ones, each that names no
    ``workloads`` or names this one."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if workload in m.get("workloads", [workload])]
