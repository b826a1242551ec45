"""One torch intra-op thread for a port test module: import
``one_torch_thread`` into the module (it is module-scoped and autouse).

The tier-1 run has six pytest workers sharing the machine's cores with
JAX's thread pools; torch's default of one thread per core in every worker
oversubscribes them, and its spinning threads then slow every worker (a
training test that takes 5 s alone took 165 s in such a run)."""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
