"""One intra-op thread for the PyTorch port's CPU tests.

The tests run under pytest-xdist with several workers on the machine's
cores.  A torch op on a tensor past torch's parallel grain (32768
elements) splits over all the cores' threads, and with every worker doing
the same, each such op waits on threads that other processes hold: one
slide's run of the morphology request (~5000 small ops on 64² and 256²
buckets) took 0.63 s alone and ~470 s in each of six concurrent
processes, 0.5-0.7 s with one thread each.  Each port test module imports
``one_torch_thread``, which runs its tests with one intra-op thread and
restores the count afterwards; only the order of torch's parallel
reductions, none of the tests' inputs or tolerances, depends on it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
