"""A run whose timed path is broken underneath reads ``correct`` false:
each fault these cells can have, planted in the program's kernel stage
(its plain versions on the CPU), with the rest of the run as it is.  The
cells run on one card with no batch of scenarios and no exchange between
chips, so those faults cannot occur here."""
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


def plant(monkeypatch, name, fault):
    """The fault in the plans' kernel stage; the kernels' caches of built
    callables start empty, so no unbroken plan is reused."""
    from repro_torch.core import acoustic, suite
    from repro_torch.kernels.stencil import codegen
    for k in (acoustic.acoustic_iso_kernel, suite.get_kernel("star3d4r")):
        monkeypatch.setattr(k, "_cache", {})
    cls, attr = ((codegen.CudaPlan, "step") if name.startswith("star")
                 else (codegen.MapPlan, "apply"))
    monkeypatch.setattr(cls, attr, fault(getattr(cls, attr)))


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("fault", [unchanged, altered])
def test_fault_reads_incorrect(monkeypatch, name, fault):
    plant(monkeypatch, name, fault)
    out = harness.run(small_cell(name), 17, 0.2, False, "cpu", time.perf_counter)
    assert out["correct"] is False and out["failed"] == 1


def test_dropped_source_reads_incorrect(monkeypatch):
    """The source's injection left out where the program makes it."""
    from repro_torch.core import acoustic
    monkeypatch.setattr(acoustic, "inject_source", lambda *a, **k: None)
    out = harness.run(small_cell("acoustic-iso-512-shot"), 17, 0.2, False, "cpu",
                      time.perf_counter)
    assert out["correct"] is False


def test_sound_run_reads_correct():
    out = harness.run(small_cell("star3d4r-512-fused"), 17, 0.2, False, "cpu",
                      time.perf_counter)
    assert out["correct"] is True and torch.isfinite(torch.tensor(
        [c["value"] for c in out["checks"].values()])).all()
