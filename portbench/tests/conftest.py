"""Shared fixtures of the benchmark's CPU tests: cells at small sizes (the
plain versions of the program's kernels run on CPU tensors), and the card
fixture that skips a test without one."""
import json
import pathlib

import pytest

# small sizes of each cell that keep its shape of work (the stencil, the
# halo, the hooks, a PML, the source's time): ``small/<workload>.json``
# holds ``{"cfg": ..., "traffic": ...}``, the keys that replace the cell's
SMALL = {p.stem: json.loads(p.read_text())
         for p in sorted((pathlib.Path(__file__).parent / "small").glob("*.json"))}


@pytest.fixture
def card():
    """Skips without a CUDA card (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def small_cell(name, **traffic):
    from portbench import harness
    small = SMALL[name]
    return harness.load_cell(name, cfg_over=small["cfg"],
                             traffic_over={**small["traffic"], **traffic})
