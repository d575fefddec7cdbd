"""Every cell, configuration, traffic and metric named in BENCHMARK.json
resolves to its file; a new cell is a new file and nothing else."""

import json
import os
import re

import pytest

from benchmark.harness import spec
from benchmark.tests.tiny import write_bench_dir

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(entry):
    files = spec.cell(entry["name"])
    assert files["cell"]["config"] == entry["config"]
    assert files["cell"]["traffic"] == entry["traffic"]
    assert files["config"]["name"] == entry["config"]
    assert hasattr(spec.driver(files["cell"]["driver"]), "run")
    assert set(files["cell"]["limits"]) >= {"det_gap", "feat_err",
                                            "nms_excess"}


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    with open(os.path.join(spec.ROOT, conf["file"])) as f:
        data = json.load(f)
    assert data["name"] == conf["name"]
    assert {"cli", "detector", "model", "weights", "assumed"} <= set(data)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert callable(spec.reader(metric["name"]))
    assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
    for w in metric.get("workloads", []):
        assert w in [c["name"] for c in BENCH["workloads"]]


def test_new_cell_is_a_file(tmp_path):
    """A throwaway cell added as one file in a copy is found by name."""
    cell = dict(spec.cell("meva_video_720p")["cell"],
                name="meva_video_720p_b16",
                cli=["--im_batch_size", "16"])
    bench_dir = write_bench_dir(str(tmp_path), cell)
    files = spec.cell("meva_video_720p_b16", bench_dir)
    assert files["cell"]["cli"] == ["--im_batch_size", "16"]
    assert files["config"]["name"] == "meva_r50_coco_partial"
    assert callable(spec.reader("mfu.video", bench_dir))
