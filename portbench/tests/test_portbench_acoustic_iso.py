"""The ``acoustic-iso-512`` configuration's own numbers and inputs, and the
fault only a stencil with a source can have."""
import json
import time

import pytest
import torch

from portbench import harness
from portbench.metrics import yardstick
from portbench.tests.conftest import small_cell

H100 = "NVIDIA H100 80GB HBM3"


def test_acoustic_step():
    c = json.loads((harness.HERE / "configs" / "acoustic-iso-512.json").read_text())
    assert yardstick.flops(c, 1) == pytest.approx(5.771e9, rel=1e-3)      # 43 × 512³
    assert yardstick.bytes_moved(c, 1) == pytest.approx(2.684e9, rel=1e-3)  # 5 grids × 512³ × 4
    # a step of st.map: one observable state a step, bound by the bytes
    s, bound = yardstick.least_seconds(c, 1, 1, H100)
    assert bound == "bytes" and s * 1e3 == pytest.approx(0.801, abs=0.001)


def test_acoustic_wave_meets_the_pml_and_an_interface():
    """At the cell's own geometry the shot is not trivial: the seeded
    model is layered, the source sits under the top PML."""
    cell = harness.load_cell("acoustic-iso-512-shot")
    cfg = {**cell.cfg, "shape": [512, 4, 4]}
    init, scalars = cell.stencil.make_state(cfg, torch.Generator().manual_seed(5), "cpu")
    vp = init["vp2"][4:-4, 6, 6].sqrt()
    assert float(vp[0]) == pytest.approx(1.5) and float(vp[-1]) == pytest.approx(4.5)
    assert len(torch.unique(vp)) == cfg["velocity"]["layers"]
    assert scalars["dt"] * 4.5 == pytest.approx(0.4, rel=1e-6)
    assert cell.stencil.source_position(cell.cfg)[0] == 12


def test_dropped_source_reads_incorrect(monkeypatch):
    """The source's injection left out where the program makes it."""
    from repro_torch.core import acoustic
    monkeypatch.setattr(acoustic, "inject_source", lambda *a, **k: None)
    out = harness.run(small_cell("acoustic-iso-512-shot"), 17, 0.2, False, "cpu",
                      time.perf_counter)
    assert out["correct"] is False
