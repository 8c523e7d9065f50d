"""The benchmark's CPU tests run on one torch thread: their tensors are
small (24³ to 32³), so torch's thread pool only adds overhead, and it
oversubscribes the cores when test workers run side by side (the cells'
small runs took about 12 times as long with six workers of eight threads
each as in one process)."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one thread for the module (test modules of the port that
    run the benchmark's small sizes import it as their own autouse
    fixture)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
