"""The benchmark's CPU tests run the port's many small torch operations;
one intra-op thread per test process keeps several pytest workers from
oversubscribing the cores (restored after each test)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
