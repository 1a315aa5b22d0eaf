"""What the port's tests and ``chip_smoke.py`` share with the package: a
cap on CPU threads, and the comparison of two top-K blocks.

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


def topk_errors(out, ref, rmax: torch.Tensor, k: int, spec_rel: float = 1e-5):
    """Compare top-K blocks (``[rows, 128]`` values and packed 8·f + off, as
    kernels K1 and K4 write them with ``emit_topk = k``) made from spectra
    that differ by float32 rounding: ``(value max |err|, that over the
    row's max power rmax, packed mismatches outside near-ties and nonzero
    lanes past k, share of the k lanes checked)``.

    A lane is a near-tie where its reference value lies within twice the
    move that a spectrum within ``spec_rel`` of the row's max |X| gives a
    power v (2·sqrt(v·rmax)·spec_rel) of a neighbour's in the ranking:
    there the two sides may rank two segments either way.
    """
    vals, packed = (x.double() for x in out)
    rv, rp = (x.double() for x in ref)
    pmax = rmax.double().reshape(-1, 1)
    fin = torch.isfinite(rv)
    zero = torch.zeros_like(rv)
    err = torch.where(fin, (vals - rv).abs(), zero)
    move = torch.where(fin, 2 * torch.sqrt(torch.where(fin, rv, zero).abs() * pmax) * spec_rel, zero)
    d = (rv[:, 1:] - rv[:, :-1]).abs() - move[:, 1:] - move[:, :-1]
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    gap = torch.full_like(rv, float("inf"))
    gap[:, 1:] = torch.minimum(gap[:, 1:], d)
    gap[:, :-1] = torch.minimum(gap[:, :-1], d)
    solid = (~fin | (gap > 0))[:, :k]
    bad = int(((packed[:, :k] != rp[:, :k]) & solid).sum())
    bad += int((torch.isfinite(vals) != fin).sum() + (vals[:, k:] != 0).sum() + (packed[:, k:] != 0).sum())
    return err.max().item(), (err / pmax).max().item(), bad, solid.float().mean().item()
