"""One intra-op thread for the port's CPU tests.

The port's tests run eager PyTorch on tiny tensors, where an intra-op
thread pool buys nothing; under pytest-xdist each worker would start one
such pool per process (one thread per core), and their spinning threads
take the cores from the other workers. Every ``tests/test_torch_*.py``
module imports ``one_torch_thread``, an autouse fixture that runs the
module with one torch thread and ``OMP_NUM_THREADS=1`` (so the CLI
subprocesses it starts run single-threaded too), and restores both after.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(n)
