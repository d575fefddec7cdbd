"""The comparison that decides ``correct`` fails where it must: the
float8 control in the program's place, and each fault planted under the
timed path, driven through the rest of a run (the look for a card
skipped) at a tiny size on the CPU, against each cell's own limits. The
same readings at the cells' own sizes come from
``tools/control_study.py`` on the card (the ``cuda`` test)."""

import time

import pytest
import torch

from benchmark.harness import check, faults, spec
from benchmark.tests.tiny import tiny_driver, tiny_files

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _driver():
    return tiny_driver(IMAGES_PER_BATCH=2)    # every frame of a batch


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell):
    res = _driver().run(tiny_files(cell), 2 ** 31 + 3, 1.0, False,
                        time.perf_counter(), device="cpu", control=True)
    assert res["correct"], res["checks"]
    ok, table = check.judge(res["control_readings"],
                            spec.cell(cell)["cell"]["limits"])
    assert not ok, table


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(cell, fault):
    res = _driver().run(tiny_files(cell), 2 ** 31 + 9, 1.0, False,
                        time.perf_counter(), device="cpu",
                        fault=faults.FAULTS[fault])
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell):
    """The cell's own sizes on the card: three seeds, the control fails
    the limits on each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    files = spec.cell(cell)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        res = spec.driver("video").run(files, seed, 3.0, False,
                                       time.perf_counter(), control=True)
        assert res["correct"], res["checks"]
        ok, table = check.judge(res["control_readings"],
                                files["cell"]["limits"])
        assert not ok, table
