"""The ``star3d4r-512`` configuration's own numbers, worked by hand."""
import json

import pytest

from portbench import harness
from portbench.metrics import yardstick

H100 = "NVIDIA H100 80GB HBM3"


def test_star_step():
    c = json.loads((harness.HERE / "configs" / "star3d4r-512.json").read_text())
    assert yardstick.flops(c, 1) == pytest.approx(6.577e9, rel=1e-3)      # 49 × 512³
    assert yardstick.bytes_moved(c, 1) == pytest.approx(1.074e9, rel=1e-3)  # (u + v) × 512³ × 4
    # a 100-step solve without hooks: one observable state, bound by the operations
    s, bound = yardstick.least_seconds(c, 100, 1, H100)
    assert bound == "operations" and s * 1e3 == pytest.approx(9.82, abs=0.01)
