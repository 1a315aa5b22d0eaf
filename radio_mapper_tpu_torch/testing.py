"""What the port's tests share with the package: a cap on CPU threads.

The test suite runs in several worker processes at once, beside tests of
live services with deadlines. PyTorch's CPU operators would otherwise
each spread over every core of the machine; every ``tests/test_torch_*``
module calls :func:`cap_cpu_threads` when it is imported.

One thread, not two: with two intra-op threads, PyTorch's CPU build on
an AMX-capable Xeon returned wrong float32 products (MKL's AVX-512/AMX
path) in a few fresh processes in a hundred. The kernel wrappers run
their plain versions at one thread themselves
(:func:`radio_mapper_tpu_torch.device.cpu_single_thread`); the cap keeps
the tests' other torch code at one thread too.
"""

from __future__ import annotations

import torch

TEST_THREADS = 1


def cap_cpu_threads(n: int = TEST_THREADS) -> None:
    """Cap PyTorch's intra-op CPU threads of this process at ``n``."""
    torch.set_num_threads(n)
