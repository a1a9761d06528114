"""Fixture for the port's CPU tests: one torch intra-op thread.

The suite runs several xdist workers side by side, each with its own JAX
and torch thread pools. torch's default of one OpenMP thread per core in
every worker oversubscribes the host, and the small elementwise ops of the
kernels' plain versions then spend most of their time spinning (measured:
the port's test files took 68 s with the default and 25 s with one thread
at 6 workers). The fixture restores the previous count afterwards.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)
