"""Kernel K3's stage schedule, replayed in numpy on the CPU.

``csrc/ct_fft.cuh`` transforms a row of n = 128·n2 samples, held as slot
rows ``x[q][p]`` (time ``q·128 + p``), in three in-place steps and a
store; n2 = a·r with ``a = min(8, 2^v₂(n2))``:

- step A: for each column p and j < r, an a-point radix-2 FFT over the
  slots ``j + r·t`` (t < a), output k times ``W_n2^{j·k}``, written to
  slot ``j + r·k``;
- step B: for each column p and k < a, the direct r-point DFT over the
  slots ``j + r·k`` (j < r); ``X[k + a·s]`` times the row twiddle
  ``W_n^{(k + a·s)·p}`` goes to slot ``s + r·k``;
- step C: the 128-point radix-2 FFT of each slot row, whose outputs come
  out bit-reversed and are written in natural order k1;
- store: slot row ``s + r·k`` to CT address ``(k + a·s)·128 + k1``.

The replica below runs exactly that schedule on the ``ct_plan`` radix
tables in complex64 and must equal ``np.fft.fft`` in CT order within 1e-5
of each row's max |X| (float32 radix-2 stages and a direct DFT of at most
24 points lose a few ulps of the row's scale).
"""

import numpy as np
import pytest

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_rows
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


def _bitrev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _c64(pairs: np.ndarray) -> np.ndarray:
    return (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)


def _radix2_dif(v, w128):
    """In-place radix-2 DIF over the list of planes ``v`` (length a power
    of two ≤ 128): the pair (t, t + h) at sub-size 2h becomes
    (a + b, (a − b)·W_2h^(t mod h)), W_2h^u = W_128^(u·64/h). Position t
    then holds output bitrev(t)."""
    h = len(v) // 2
    while h >= 1:
        for t in range(len(v)):
            if t & h:
                continue
            a, b = v[t], v[t + h]
            v[t] = a + b
            v[t + h] = (a - b) * w128[(t & (h - 1)) * (64 // h)]
        h //= 2
    return v


def k3_registers(x: np.ndarray) -> np.ndarray:
    """K3's steps A, B and C on complex64 rows ``x [rows, n]``:
    ``v[:, sr, l, j]`` is value j of lane l after step C on slot row sr,
    position 4l + j of the row, which holds bin bitrev7(4l + j)."""
    rows, n = x.shape
    t = ct_plan.radix_tables(n)
    n2, a, r = t.n2, t.a, t.r
    w128, wn2, wr = _c64(t.w1), _c64(t.wn2), _c64(t.wr)
    _, _, _, _, _, _, twre, twim = ct_plan.ct_constants(n)
    tw = (twre + 1j * twim).astype(np.complex64)  # [n2, 128]
    xs = x.reshape(rows, n2, 128).astype(np.complex64)  # slot rows

    # step A
    abits = a.bit_length() - 1
    for j in range(r):
        v = _radix2_dif([xs[:, j + r * u].copy() for u in range(a)], w128)
        for u in range(a):
            k = _bitrev(u, abits)
            xs[:, j + r * k] = v[u] * wn2[j * k]

    # step B
    for k in range(a):
        y = xs[:, r * k:r * (k + 1)].copy()  # [rows, r, 128]
        for s in range(r):
            acc = np.zeros((rows, 128), np.complex64)
            for j in range(r):
                acc += wr[j, s] * y[:, j]
            xs[:, s + r * k] = acc * tw[k + a * s]

    # step C: position p of a slot row holds bin bitrev7(p)
    planes = _radix2_dif([xs[:, :, p].copy() for p in range(128)], w128)
    return np.stack(planes, axis=-1).reshape(rows, n2, 32, 4)


def k3_schedule(x: np.ndarray) -> np.ndarray:
    """K3's steps A, B, C and store on complex64 rows ``x [rows, n]``."""
    rows, n = x.shape
    t = ct_plan.radix_tables(n)
    n2, a, r = t.n2, t.a, t.r
    v = k3_registers(x).reshape(rows, n2, 128)
    nat = np.empty_like(v)
    for p in range(128):
        nat[:, :, _bitrev(p, 7)] = v[:, :, p]

    # store
    out = np.empty_like(nat)
    for k in range(a):
        for s in range(r):
            out[:, k + a * s] = nat[:, s + r * k]
    return out.reshape(rows, n)


@pytest.mark.parametrize("n", [640, 1024, 1152, 2304, 5120, 5760, 6656, 9216, 16384, 17408, 24576])
def test_schedule_replica_equals_numpy_fft_in_ct_order(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))).astype(np.complex64)
    x[1, n // 3:] += 30 * np.exp(2j * np.pi * 411 * np.arange(n - n // 3) / n)  # a strong tone
    ours = k3_schedule(x)
    ref = np.fft.fft(x.astype(np.complex128))[..., ct_plan.ct_permutation(n)]
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()


def test_radix_tables_are_float64_rounded_once():
    """The tables are float64 roots of unity rounded to float32, and every
    length the pipelines plan (multiples of 1024 up to 24576) has n1 = 128,
    a = 8 and r ≤ 24, so step B holds its r inputs in registers."""
    for n in range(128, fft_rows.MAX_N + 1, 128):
        if ct_plan.ct_supported(n):
            assert ct_plan.ct_split(n)[0] == 128, n
    for n in (640, 1152, 5120, 5760, 17408, 24576):
        t = ct_plan.radix_tables(n)
        assert t.a * t.r == t.n2 and t.a == min(8, t.n2 & -t.n2)
        for table, m, e in (
            (t.w1, t.n1, np.arange(t.n1 // 2)),
            (t.wn2, t.n2, np.arange(t.n2)),
            (t.wr, t.r, np.outer(np.arange(t.r), np.arange(t.r)) % t.r),
        ):
            w = np.exp(-2j * np.pi * e / m)  # complex128
            assert table.dtype == np.float32
            np.testing.assert_array_equal(table[..., 0], w.real.astype(np.float32))
            np.testing.assert_array_equal(table[..., 1], w.imag.astype(np.float32))
    lengths = sorted({ct_plan.plan_nfft(m) for m in range(1, 24_577, 97)})
    assert lengths[-1] == 24_576
    for n in lengths:
        _, a, r = ct_plan.radix_split(n)
        assert a == 8 and r <= 24, (n, a, r)
