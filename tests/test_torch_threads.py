"""The port's CPU tests run torch on one intra-op thread.

Their ops are smoke-sized: microseconds of arithmetic each. Under
pytest-xdist every worker process keeps an intra-op pool of one thread a
core, so a few workers oversubscribe the host and each small op waits on
descheduled threads: a 4-block einsum of 16 rows took ~0.03 ms a call
alone and ~40 ms with six such processes on an 8-core host, where one
thread each kept it at ~0.03 ms. Every port test module imports
``one_torch_thread``, an autouse fixture, from here.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op pool at one thread for the module, then put back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_module_runs_on_one_thread():
    assert torch.get_num_threads() == 1
