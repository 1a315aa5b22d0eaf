"""Kernel K7's radix design, replayed in numpy on the CPU.

``csrc/fft_natural_radix.cu`` transforms a row of n = 4096, 8192 or 16384
points with one block of T = n / 16 threads, register m of thread t
holding point ``t + T·m`` of each pass's input. The passes are
:func:`fft_natural.radix_plan`'s Stockham plan (16·16·16, then a radix-2
or radix-4 pass): butterfly j of pass (R, NS) takes registers ``b + B·r``
of thread ``j mod T`` (b = j // T, B = 16 / R), twiddles input r by
``W_{NS·R}^{r·(j mod NS)}`` from the plan's table, runs a radix-2 DIF
R-point FFT whose position i holds output ``brev(i)``, and writes output
r to element ``(j // NS)·NS·R + j mod NS + r·NS`` of the next pass's
input: shared-memory word ``swizzle(element)`` of each plane, or, after
the last pass, the natural bin in device memory.

The replica runs exactly that in complex64 and must equal ``np.fft.fft``
in natural order within 1e-5 of each row's max |X| (float32 radix
stages lose a few ulps of the row's scale). For every exchange it also
computes each warp's 32 shared-memory words, for the writes and for the
reads, and holds every bank to at most two accesses. No JAX here.
"""

import numpy as np
import pytest

from radio_mapper_tpu_torch.ops.cuda import fft_natural
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

WARP, BANKS = 32, 32
# W_16^e, e < 8: the kernel's literal constants, float64 rounded once
W16 = np.exp(-2j * np.pi * np.arange(8) / 16).astype(np.complex64)


def swizzle(a):
    """The kernel's exchange-buffer word for element ``a`` of a plane."""
    return a ^ ((a >> 5) & 31)


def _brev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _dif(y):
    """Radix-2 DIF over the list of planes ``y`` (R ≤ 16): the pair (i, i + h)
    of sub-size 2h becomes (a + b, (a − b)·W_16^((i mod h)·8/h)); position i
    then holds output brev(i)."""
    h = len(y) // 2
    while h >= 1:
        for i in range(len(y)):
            if i & h:
                continue
            a, b = y[i], y[i + h]
            y[i] = a + b
            y[i + h] = (a - b) * W16[(i & (h - 1)) * (8 // h)]
        h //= 2
    return y


def _exchange_write(j, r, radix, ns):
    """Element of the next pass's input that output r of butterfly j goes to."""
    return (j // ns) * ns * radix + j % ns + r * ns


def radix_schedule(x: np.ndarray) -> np.ndarray:
    """The kernel's passes on complex64 rows ``x [rows, n]``."""
    rows, n = x.shape
    plan = fft_natural.radix_plan(n)
    P, T = plan.points, plan.threads
    tw = (plan.twiddles[:, 0] + 1j * plan.twiddles[:, 1]).astype(np.complex64)
    t = np.arange(T)
    reg = t[:, None] + T * np.arange(P)[None, :]  # [T, P]: the element register m of thread t holds
    v = x.astype(np.complex64)[:, reg]  # the loads: [rows, T, P]
    out = np.empty((rows, n), np.complex64)
    for p, (radix, ns) in enumerate(plan.passes):
        last = p == len(plan.passes) - 1
        B = P // radix
        bits = radix.bit_length() - 1
        smem = np.full((rows, n), np.nan, np.complex64)  # both planes, by word
        for b in range(B):
            j = t + T * b
            y = [v[:, :, b + B * r].copy() for r in range(radix)]
            if ns > 1:
                for r in range(1, radix):
                    y[r] *= tw[plan.offsets[p] + (r - 1) * ns + j % ns]
            y = _dif(y)
            for r in range(radix):
                val = y[_brev(r, bits)]
                dst = _exchange_write(j, r, radix, ns)
                if last:
                    assert (dst == j + r * (n // radix)).all()  # natural bin = t + T·(b + B·r)
                    out[:, dst] = val
                else:
                    smem[:, swizzle(dst)] = val
        if not last:
            assert not np.isnan(smem).any()  # every word written: the exchange is a permutation
            v = smem[:, swizzle(reg)]
    return out


@pytest.mark.parametrize("n", [4096, 8192, 16384])
def test_schedule_replica_equals_numpy_fft_in_natural_order(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)
    x[1, n // 3:] += 30 * np.exp(2j * np.pi * 411 * np.arange(n - n // 3) / n)  # a strong tone
    ours = radix_schedule(x)
    ref = np.fft.fft(x.astype(np.complex128))
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()


def _max_per_bank(words: np.ndarray) -> int:
    """Most accesses any bank gets from one warp: ``words [warps, 32]``."""
    banks = words % BANKS
    return max(np.bincount(w, minlength=BANKS).max() for w in banks)


@pytest.mark.parametrize("n", [4096, 8192, 16384])
def test_exchanges_hit_each_bank_at_most_twice_per_warp(n):
    """Each exchange's writes (one store instruction per output r of
    butterfly b) and reads (one load per register m), per warp, for each
    plane (the planes sit n words apart, a multiple of 32: the same banks)."""
    plan = fft_natural.radix_plan(n)
    P, T = plan.points, plan.threads
    t = np.arange(T).reshape(-1, WARP)  # [warps, 32] lanes
    assert T % WARP == 0 and n % BANKS == 0
    worst = {}
    for p, (radix, ns) in enumerate(plan.passes[:-1]):  # the last pass stores to device memory
        B = P // radix
        writes = [swizzle(_exchange_write(t + T * b, r, radix, ns)) for b in range(B) for r in range(radix)]
        reads = [swizzle(t + T * m) for m in range(P)]
        worst[p] = (max(map(_max_per_bank, writes)), max(map(_max_per_bank, reads)))
        assert worst[p][0] <= 2 and worst[p][1] <= 2, (p, worst[p])
    # the first pass's stride-16 write is conflict-free once swizzled, not 16-way
    assert worst[0][0] == 1
    assert _max_per_bank(_exchange_write(t, 0, 16, 1)) == 16


@pytest.mark.parametrize("n", [4096, 8192, 16384])
def test_radix_plan_tables_are_float64_roots_rounded_once(n):
    plan = fft_natural.radix_plan(n)
    last = {4096: (), 8192: ((2, 4096),), 16384: ((4, 4096),)}[n]
    assert plan.passes == ((16, 1), (16, 16), (16, 256)) + last
    assert plan.points == fft_natural.POINTS == 16 and plan.threads * 16 == n
    assert plan.twiddles.dtype == np.float32
    off = 0
    for (radix, ns), o in zip(plan.passes, plan.offsets):
        assert o == off  # the kernel's offsets: 0, 15·16, 15·16 + 15·256
        if ns == 1:
            continue
        e = np.outer(np.arange(1, radix), np.arange(ns))
        w = np.exp(-2j * np.pi * e / (ns * radix)).reshape(-1)  # complex128
        block = plan.twiddles[o:o + (radix - 1) * ns]
        np.testing.assert_array_equal(block[:, 0], w.real.astype(np.float32))
        np.testing.assert_array_equal(block[:, 1], w.imag.astype(np.float32))
        off += (radix - 1) * ns
    assert off == len(plan.twiddles)
    assert plan.offsets[1:3] == (0, 15 * 16)


def test_design_routes_by_length():
    for n in (4096, 8192, 16384):
        assert fft_natural.design(n) == "radix", n
    for n in (32768, 65536):
        assert fft_natural.design(n) == "cluster", n
    for n in (17280, 1000, 2048, 12288, 131072, 49152):
        with pytest.raises(ValueError):
            fft_natural.design(n)
    with pytest.raises(ValueError):
        fft_natural.radix_plan(32768)
