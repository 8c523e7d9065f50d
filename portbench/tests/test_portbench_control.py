"""The control: the program's own path in the precision below the
configuration's (bf16 grids for f32) fails the cell's limits, where the
program as configured passes them.  On the CPU at small sizes; on the
card at the cell's own size (``-m gpu``)."""
import pytest

from portbench import calibrate, harness
from portbench.tests.conftest import SMALL, small_cell


def readings(cell, seeds, dtype, device):
    return calibrate.readings(cell, seeds, dtype, device, emit=lambda s: None)


def verdicts(cell, device, seeds=(1, 2, 3)):
    program = readings(cell, seeds, cell.cfg["dtype"], device)
    control = readings(cell, seeds, calibrate.CONTROL_DTYPE[cell.cfg["dtype"]], device)
    for row in program:
        assert all(v <= cell.limits[n] for n, v in row["checks"].items()), row
    for row in control:
        assert any(v > cell.limits[n] for n, v in row["checks"].items()), row


@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_fails_where_the_program_passes(name):
    verdicts(small_cell(name), "cpu", seeds=(1, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_on_the_card_at_the_cells_size(card, name):
    verdicts(harness.load_cell(name), "cuda")
