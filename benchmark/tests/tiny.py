"""Tiny copies of the benchmark's cells for CPU tests: the cell's own
configuration and traffic with the frame cut to 64x96, 50 proposals, the
R50 depth, float32, a short window, and the video driver with fewer
warm-up, sampled and traced batches."""

from __future__ import annotations

import copy
import json
import os

from benchmark.harness import spec

H, W = 64, 96
DRIVER_CONSTANTS = {"WARMUP_BATCHES": 1, "SAMPLE_BATCHES": 2,
                    "IMAGES_PER_BATCH": 1, "TRACE_SKIP": 2, "TRACE_LEAD": 1,
                    "TRACE_BATCHES": 2}


def _set_flag(cli, flag, value):
    cli = list(cli)
    if flag in cli:
        cli[cli.index(flag) + 1] = value
    else:
        cli += [flag, value]
    return cli


def tiny_files(cell_name: str) -> dict:
    files = copy.deepcopy(spec.cell(cell_name))
    conf, cell, traffic = files["config"], files["cell"], files["traffic"]
    cli = [c for c in conf["cli"] if c not in ("--resnet50",)]
    cli = _set_flag(cli, "--short_edge_size", str(H))
    cli = _set_flag(cli, "--max_size", str(W))
    cli = _set_flag(cli, "--rpn_test_post_nms_topk", "50")
    conf["cli"] = cli + ["--resnet50"]
    conf["detector"]["compute_dtype"] = "float32"
    conf["model"].update(resnet_blocks=[3, 4, 6, 3], max_size=W,
                         rpn_post_nms_topk=50)
    cell["cli"] = _set_flag(cell["cli"], "--im_batch_size", "2")
    traffic.update(height=H, width=W, ring_frames=4, clip_seconds=2)
    return files


def tiny_driver(**constants):
    """A fresh copy of the video driver module with ``DRIVER_CONSTANTS``
    (and ``constants``) in place of its own."""
    drv = spec.driver("video")
    for k, v in dict(DRIVER_CONSTANTS, **constants).items():
        assert hasattr(drv, k), k
        setattr(drv, k, v)
    return drv


def write_bench_dir(root: str, extra_cell: dict = None) -> str:
    """A copy of BENCHMARK.json and the benchmark's data files under
    ``root``, with ``extra_cell`` (a cell file) added; returns the copy's
    benchmark directory."""
    import shutil
    bench = os.path.join(root, "benchmark")
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), root)
    if extra_cell is not None:
        with open(os.path.join(bench, "workloads",
                               extra_cell["name"] + ".json"), "w") as f:
            json.dump(extra_cell, f)
    return bench
