"""A cap on PyTorch's CPU threads for the port's test files.

The suite runs in several pytest-xdist workers on the host's cores. A
``test_torch_*`` file left at PyTorch's default (one thread per core)
spreads its matrix products over every core while the other workers run
the orchestrator's host-timing tests (servers, threads and deadlines),
which then lose their races more often. Each ``test_torch_*`` module
imports ``few_torch_threads``, an autouse module fixture that holds
PyTorch to ``THREADS`` threads while the module's tests run.
"""
import pytest
import torch

THREADS = 1


@pytest.fixture(autouse=True, scope='module')
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(before)
