"""The control at each cell's own size, on the card: the comparison must
find it wrong on three seeds."""

import pytest

from perfbench import control, run

CELLS = run.load_spec()["workloads"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS, ids=lambda w: w["name"])
def test_control_reads_wrong_at_cell_size(cuda_device, cell):
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        out = control.readings(cell, seed, 200, cuda_device)
        assert out["wrong_answers"] > out["limit"], out
