"""The fixture that runs torch on one thread in a port test module.

A module imports it (``from torch_threads import torch_one_thread``), which
makes it that module's autouse fixture."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """Torch on one thread for the module: at these sizes its work is a few
    small ops at a time, which a pool of threads shared with the other test
    processes on the host waits on far longer than it computes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
