"""Shared by the port's CPU tests (``tests/test_torch_*.py``): one torch
intra-op thread per test process.

The port's plain decode versions run thousands of tiny tensor ops per
step.  The test suite runs in several worker processes at once, and a
thread pool of one thread per core in each of them leaves every parallel
region waiting for threads the other workers have taken: six workers each
running a test that takes 12 s alone did not finish in 600 s with the
default pool, and took 12-18 s with one thread each."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
