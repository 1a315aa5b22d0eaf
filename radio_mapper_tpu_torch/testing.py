"""What the port's tests share with the package: a cap on CPU threads.

The test suite runs in several worker processes at once, beside tests of
live services with deadlines. PyTorch's CPU operators would otherwise
each spread over every core of the machine; every ``tests/test_torch_*``
module calls :func:`cap_cpu_threads` when it is imported.
"""

from __future__ import annotations

import torch

TEST_THREADS = 2


def cap_cpu_threads(n: int = TEST_THREADS) -> None:
    """Cap PyTorch's intra-op CPU threads of this process at ``n``."""
    torch.set_num_threads(n)
