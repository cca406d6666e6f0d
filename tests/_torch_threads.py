"""A fixture that runs a test on one PyTorch intra-op thread.

The suite runs its test files in parallel worker processes
(pytest-xdist). PyTorch's default pool of one intra-op thread per core
then oversubscribes the machine, and the many small ops of the
reduced-model training tests slow down by an order of magnitude (a
golden LM run: 25 s on one thread against 317 s on eight, with five
other processes busy on an 8-core machine). The previous thread count
is restored after the test, so other tests keep their own setting.
"""

import pytest
import torch


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
