"""Shared fixture of the PyTorch port's CPU tests.

Tier-1 runs several pytest workers on the machine's cores, and torch's
intra-op pool would claim every core in each of them; the port's tests
are small, so they run torch on one thread and leave the cores to the
timing-sensitive cluster tests in the other workers.
"""

import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
