"""The one-thread fixture of the port's CPU test files: import
``one_torch_thread`` into a test module to run its torch work on one
intra-op thread (and its spawned gloo ranks too, ``run_local`` giving them
the caller's count). The suite runs several test processes at once, and
torch's per-process thread pools then oversubscribe the cores and slow each
other down many times over."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
