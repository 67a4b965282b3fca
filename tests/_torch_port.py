"""Shared fixture of the port's CPU parity tests."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run each test on one intra-op thread. The suite runs in several
    worker processes at once, and torch's default pool (one thread per
    core in every worker) oversubscribes the cores: its spinning threads
    then make small CPU ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
