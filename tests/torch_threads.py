"""An autouse fixture for the port's heavier test files: torch held at two
CPU threads while the file runs, put back after. The suite runs six files
at once on the machine's cores (``-n 6``), and torch's default of a thread
a core then oversubscribes them: a CPU training step read 50 to 60 times
its time alone. A file takes it with ``from torch_threads import
two_torch_threads``."""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
