"""A module fixture that runs torch's CPU operations on one thread.

Under ``pytest -n 6`` on an 8-core host every worker's torch starts one
OpenMP thread a core, so 48 threads contend for 8 cores, and waiting
threads spin.  The train entry's resume test took 11 s alone and 384 s
beside five other workers; six copies of it run together did not end in
900 s, and took 15-17 s each on one thread a process.  A file that drives
torch's CPU kernels hard imports this fixture; the thread count is put
back when the file's tests are done.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
