"""One torch intra-op thread for the port's heavy CPU tests (import the
fixture into a test module to apply it to the module).

pytest-xdist runs six workers on the machine's cores.  torch's default
pool, one thread per core in each worker, then spends its time in the
pool's spin-wait barriers: a rehearsal that takes 24 s alone took ~470 s
beside the other workers, and 104 s with one thread (six copies at once
on eight cores).  Subprocesses get OMP_NUM_THREADS=1 for the same
reason."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
