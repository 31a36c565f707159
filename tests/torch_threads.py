"""An autouse fixture for the port's CPU tests of small networks: each test
runs torch on one CPU thread and gives the previous count back after.

Under ``pytest -n 6`` every worker's torch would otherwise start as many
intra-op threads as the machine has cores, and small learners then spend
their time waiting on each other's threads (on an 8-core machine the D4PG
acceptance took ten times as long beside five other workers as alone).
One thread also makes a learner's float sums, and so a learning run, the
same on every machine.

Import it into a test module to use it there::

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
