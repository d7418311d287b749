"""The control and the planted faults come out as not correct, and the
program as correct, at sizes a test run holds; on the card, the same at
the cells' own sizes (`perfbench.calibrate` reads them over many seeds
for the limits)."""

import json

import pytest

import dprast_torch
from perfbench.calibrate import reading

from .conftest import REPO

# (cell, the control, the faults the cell can have): a fit of one pose has
# no half of its batch to leave out
TINY = [("t2_fit", "binned_bf16", ("unchanged", "half_batch")),
        ("t3_fit", "reference_bf16", ("unchanged",)),
        ("t2_project", "binned_bf16", ("altered",)),
        ("t3_project", "reference_bf16", ("altered",))]


@pytest.mark.parametrize("cell, control, faults", TINY)
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 7])
def test_control_and_faults_fail(root, cell, control, faults, seed):
    ok, numbers, _ = reading(root, cell, "program", seed, 0.1, device="cpu",
                          program=dprast_torch.raster)
    assert ok, numbers
    for mode in (control,) + faults:
        ok, numbers, _ = reading(root, cell, mode, seed, 0.1, device="cpu",
                              program=dprast_torch.raster)
        assert not ok, (mode, numbers)


def _cell_control(cell):
    return json.loads((REPO / "perfbench/cells" / f"{cell}.json")
                      .read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["proj1024_fit", "vol1024_fit",
                                  "proj1024_project", "vol1024_project"])
def test_control_fails_at_the_cells_size(cell):
    spec = _cell_control(cell)
    for seed in (1, 2, 3):
        ok, numbers, _ = reading(REPO, cell, "program", seed, 0.5)
        assert ok, numbers
        for mode in [spec["control"]] + spec.get("faults", []):
            ok, numbers, _ = reading(REPO, cell, mode, seed, 0.5)
            assert not ok, (mode, numbers)
