"""An autouse fixture for the training tests: one torch intra-op thread
while a module's tests run.  The suite runs several pytest workers at
once, and their thread pools then spin against each other: a 20 s
training test took 455 s among six workers with torch's default of one
thread per core, and 21 s with one thread."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
