"""The one-thread fixture of the port's test modules (a helper module:
pytest collects only ``test_*.py``).

A module imports it with ``from torch_threads import _one_torch_thread  #
noqa: F401``; the fixture is module-scoped and autouse, so every test of
that module runs its torch ops on one intra-op thread.  The suite runs
several test processes at once (``-n 6``), and each process's torch thread
pool would otherwise oversubscribe the cores with the many small ops of the
port's tests."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
