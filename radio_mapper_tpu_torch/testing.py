"""What the port's tests share with the package: a cap on CPU threads.

The test suite runs in several worker processes at once, beside tests of
live services with deadlines. PyTorch's CPU operators would otherwise
each spread over every core of the machine; every ``tests/test_torch_*``
module calls :func:`cap_cpu_threads` when it is imported.

One thread, not two: with two intra-op threads, PyTorch 2.13's CPU build
on an AMX-capable Xeon returned a wrong result from the first plain K5
call of about 3% of fresh processes (lag windows off by 2.6e-3 of their
maximum in some pairs, the same wrong values every time; later calls in
the same process right), and none of 256 with one thread. The fault is
inside PyTorch's CPU threading, not in the port's arithmetic.
"""

from __future__ import annotations

import torch

TEST_THREADS = 1


def cap_cpu_threads(n: int = TEST_THREADS) -> None:
    """Cap PyTorch's intra-op CPU threads of this process at ``n``."""
    torch.set_num_threads(n)
