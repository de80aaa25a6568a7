"""One torch thread for each of the port's test files (``test_torch_*.py``
import ``one_thread``, which is autouse there).

The suite runs under six pytest-xdist workers, and torch's default
intra-op pool takes every core in each of them.  The port's tests issue
many small operations (token loops, small models' steps, gradchecks), and
with the other workers busy each operation's hand-off to the pool costs
more than its work: ``test_flash_attention_fn_gradcheck`` took 30-126 s a
case on the default pool beside five busy workers and under 1.5 s on one
thread.  The thread count is the worker's own, so it is set back after
each file.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
