"""The roofline's table of peaks (each configuration's counts, worked by
hand, are in ``test_portbench_<stencil>.py``)."""
import pytest

from portbench.metrics import yardstick


def test_unknown_card_has_no_peaks():
    with pytest.raises(KeyError):
        yardstick.peaks("cpu")
