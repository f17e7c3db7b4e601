"""One torch intra-op thread for a test module.

The suite runs on several worker processes at once; torch's default of one
intra-op thread per core then oversubscribes the cores, and its spinning
threads slow every worker several times over.  A module takes the fixture
by importing it::

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module; the count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
