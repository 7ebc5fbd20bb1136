"""On the chip: the control of the MobileNetV3-Large cell, at the cell's own
size, on three seeds, is rejected by the check
(``python -m pytest bench -m chip``)."""
import time

import pytest

from harness.cell import run_cell
from harness.control import Control

SEEDS = (2 ** 31 + 135, 2 ** 31 + 235, 2 ** 31 + 335)


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["mobilenet-v3-224.dse_exhaustive"])
def test_control_is_rejected_at_the_cells_size(chip, cell):
    for seed in SEEDS:
        r = run_cell(cell, seed, 3.0, False, time.perf_counter(),
                     program=Control)
        assert not r["correct"], (chip, seed, r["checks"])
