"""A module-scoped autouse fixture for the port's serving tests: one torch
intra-op thread while the module runs. The suite runs in several worker
processes at once, and torch's default of a thread per core oversubscribes
the CPU: six concurrent runs of ``tests/test_torch_prefix.py``'s stream
test took 552 s with the default threads and 31 s with one."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
