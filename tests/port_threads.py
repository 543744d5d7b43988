"""One torch intra-op thread while a port test file runs.

The port's tests run small tensors, and the suite runs in several worker
processes on a few cores, where each process's torch thread pool would
oversubscribe them: six concurrent runs of ``test_torch_variants.py``
took 93 s with one thread each against 138 s with eight (alone, 56 s
against 50 s). A port test file imports the fixture, which is autouse:

    from port_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
