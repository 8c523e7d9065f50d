"""Shared fixtures of the benchmark's CPU tests: cells at small sizes (the
plain versions of the program's kernels run on CPU tensors), and the card
fixture that skips a test without one."""
import pytest

# small sizes of each cell that keep its shape of work: the stencil, the
# halo, the hooks, a PML, the source's time
SMALL = {
    "star3d4r-512-fused": ({"shape": [24, 24, 24]}, {"steps_per_solve": 20}),
    "acoustic-iso-512-shot": ({"shape": [32, 32, 32], "pml_width": 4},
                              {"steps_per_solve": 60}),
}


@pytest.fixture
def card():
    """Skips without a CUDA card (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def small_cell(name, **traffic):
    from portbench import harness
    cfg, tr = SMALL[name]
    return harness.load_cell(name, cfg_over=cfg, traffic_over={**tr, **traffic})
