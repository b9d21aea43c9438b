"""One intra-op thread for the port's CPU parity tests.

The tier-1 command runs several pytest workers beside JAX's own thread
pools; PyTorch's default of one intra-op thread per core then
oversubscribes the CPU, and the port's many small tensor operations slow
down several-fold. Test modules import the fixture below to run their
PyTorch operations on one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
