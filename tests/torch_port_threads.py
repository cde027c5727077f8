"""The port's CPU tests that run many small PyTorch ops import `one_thread`
into their module, which then runs each of its tests on one intra-op
thread (restored after).

Beside the other busy test processes (the tier-1 run's xdist workers),
PyTorch's intra-op thread pool makes each small op wait for its threads:
the plain Viterbi over 15,001 frames took 370 s on 8 threads against 0.5 s
on one, four such processes on 8 cores; the fused analysis pass at 0.7 s,
about 65 s against 0.65 s.  One thread changes no input and no gate.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
