"""The port's CPU tests run torch on one intra-op thread.

The suite runs in several worker processes at once, and each worker's
torch would otherwise start a pool of threads as wide as the machine: the
pools starve one another, and every op waits for threads that other
workers hold (eight cases of 0.6-0.7 s each alone took 26-50 s each in
the suite). Every ``tests/test_torch_*.py`` module takes this fixture up
with ``from torch_threads import one_thread``. Tests that set their own
thread count inside (``test_torch_determinism.py``) keep doing so."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests and fixtures, the count
    before it restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
