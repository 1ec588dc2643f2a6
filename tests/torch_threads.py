"""One intra-op thread for the port's CPU tests.

The suite runs under xdist, six workers on the host's cores beside XLA's
own threads. There a tiny model's torch ops spread over every core only
contend: a tiny stage-1 update that takes 1.5 s on one thread took 51 s on
eight beside five busy processes. A port test module imports
`one_torch_thread`, an autouse fixture, so that its tests (and its module
fixtures) run on one thread; the count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
