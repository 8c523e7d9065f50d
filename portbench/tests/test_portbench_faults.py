"""A run whose timed path is broken underneath reads ``correct`` false:
each fault these cells can have, planted in the program's kernel stage
(its plain versions on the CPU), with the rest of the run as it is.  The
cells run on one card with no batch of scenarios and no exchange between
chips, so those faults cannot occur here.  A fault only a stencil with a
source can have is in that stencil's own test file."""
import math
import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import SMALL, small_cell


def unchanged(real):
    """A step that returns its state unchanged."""
    def step(self, *args, **kw):
        return args[0]
    return step


def altered(real):
    """An answer altered where it is produced: one interior cell of the
    stencil's output off by 1 % of the largest magnitude."""
    def step(self, *args, **kw):
        out = real(self, *args, **kw)
        for g in self.out_grids:
            t = args[0][g]
            c = tuple(n // 2 for n in t.shape)
            t[c] += 0.01 * float(t.abs().max()) + 1e-3
        return out
    return step


# the plans' kernel stage each driver's timed path runs
STAGE = {"fused_solves": ("CudaPlan", "step"), "map_steps": ("MapPlan", "apply")}


def plant(monkeypatch, cell, fault):
    """The fault in the kernel stage of the cell's driver; the cell's
    kernel's cache of built callables starts empty, so no unbroken plan is
    reused."""
    from repro_torch.kernels.stencil import codegen
    monkeypatch.setattr(cell.stencil.kernel(), "_cache", {})
    name, attr = STAGE[cell.traffic["driver"]]
    cls = getattr(codegen, name)
    monkeypatch.setattr(cls, attr, fault(getattr(cls, attr)))


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("fault", [unchanged, altered])
def test_fault_reads_incorrect(monkeypatch, name, fault):
    cell = small_cell(name)
    plant(monkeypatch, cell, fault)
    out = harness.run(cell, 17, 0.2, False, "cpu", time.perf_counter)
    assert out["correct"] is False and out["failed"] == 1


def smallest():
    """The cell whose small size does the least work."""
    def work(name):
        cell = small_cell(name)
        return math.prod(cell.cfg["shape"]) * cell.traffic["steps_per_solve"]
    return min(sorted(SMALL), key=work)


def test_sound_run_reads_correct():
    out = harness.run(small_cell(smallest()), 17, 0.2, False, "cpu", time.perf_counter)
    assert out["correct"] is True and torch.isfinite(torch.tensor(
        [c["value"] for c in out["checks"].values()])).all()
