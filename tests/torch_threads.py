"""An autouse fixture for the port's heavier CPU test files, imported by name
into each: every test runs on one torch thread. The suite runs in several
worker processes at once, where torch's default of a thread per core in
every worker spends most of its time at thread barriers on small tensors
(tests/test_torch_interface.py's streaming decode took 1.5 s alone and 45 s
in the 6-worker suite)."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
