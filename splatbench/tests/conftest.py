"""The harness tests run on the CPU at small sizes (splatbench.tests.tiny),
with few threads per worker."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
