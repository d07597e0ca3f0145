"""Shared set-up of the port's CPU test files."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread, then restore the count. The
    suite runs six worker processes on the machine's cores; a torch op
    that spreads over every core in each of them waits at its barriers for
    threads the other workers keep busy (the stage-2 and CLI files took
    ten to fifty times longer so than alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
