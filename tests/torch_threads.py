"""A module-scoped fixture for the port's test files: one intra-op torch
thread while the module runs.  Under the Tier-1 command six test workers
share the machine's cores, and torch's default of one thread per core
oversubscribes them, which slows the small solves of these files 10-30x.

    from .torch_threads import one_torch_thread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
