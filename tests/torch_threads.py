"""torch on one CPU thread for a test that times the host, shared by the
port's tests whose figures a crowded host stretches.

Beside the other test workers, a worker's torch thread pool
oversubscribes the cores: the engine then served 6 tokens in 5 s where
one thread serves ~1,400 (``tests/test_torch_exaone.py``), and the
first profiler range entered after a CPU model step (a paged round's
``serve.readback``) outlasted its span by 40-60 us, past
``tests/test_torch_trace.py``'s 50 us floor; on one thread the median
excess read 6-10 us less (an 8-core CPU host, six busy workers beside).
"""

import pytest
import torch


@pytest.fixture
def one_thread():
    """torch on one CPU thread for the test, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
