"""The roofline's counts against numbers worked by hand."""
import json

import pytest

from portbench import harness
from portbench.metrics import yardstick

H100 = "NVIDIA H100 80GB HBM3"


def cfg(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


def test_star_step():
    c = cfg("star3d4r-512")
    assert yardstick.flops(c, 1) == pytest.approx(6.577e9, rel=1e-3)      # 49 × 512³
    assert yardstick.bytes_moved(c, 1) == pytest.approx(1.074e9, rel=1e-3)  # (u + v) × 512³ × 4
    # a 100-step solve without hooks: one observable state, bound by the operations
    s, bound = yardstick.least_seconds(c, 100, 1, H100)
    assert bound == "operations" and s * 1e3 == pytest.approx(9.82, abs=0.01)


def test_acoustic_step():
    c = cfg("acoustic-iso-512")
    assert yardstick.flops(c, 1) == pytest.approx(5.771e9, rel=1e-3)      # 43 × 512³
    assert yardstick.bytes_moved(c, 1) == pytest.approx(2.684e9, rel=1e-3)  # 5 grids × 512³ × 4
    # a step of st.map: one observable state a step, bound by the bytes
    s, bound = yardstick.least_seconds(c, 1, 1, H100)
    assert bound == "bytes" and s * 1e3 == pytest.approx(0.801, abs=0.001)


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        yardstick.peaks("cpu")
