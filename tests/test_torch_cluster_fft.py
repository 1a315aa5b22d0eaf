"""The cluster designs of kernels K7 (rows of 32768 and 65536 points) and
K3 (rows past one block's shared memory), replayed in numpy on the CPU.

K7 (``csrc/fft_natural_cluster.cu``): a row of n points is a cluster of
c = n/16384 blocks. Block r folds a radix-c decimation-in-frequency stage
into its loads, y_r[j] = W_n^(r·j) · Σ_s x[j + s·m]·W_c^(r·s) (m = n/c),
runs the radix design's 16384-point passes on y_r
(``test_torch_fft_natural_radix.radix_schedule``) with the last pass
stored to its own swizzled exchange buffer, and then writes natural bins
[r·m, (r+1)·m): thread t's bin g = r·m + t + T·i is Y_(t mod c)[g / c],
read from that partner's buffer. The replica must equal ``np.fft.fft``
within 1e-5 of each row's max |X|, write every bin once, read every
partner element once, and keep each warp's reads of one buffer in
distinct banks.

K3 (``csrc/fft_rows_ct_cluster.cu``, the long rows with n1 = 128 and
256; 384, 640 and 896 take the wide design,
``tests/test_torch_k1_cluster.py``): block ``rank`` of a
row's cluster owns columns [rank·n1/c, (rank+1)·n1/c) as tiles of
``cols`` columns, runs steps A and B on them in place, and then step C on
slot rows [rank·n2/c, (rank+1)·n2/c), lane l gathering positions P·l + 2u
and P·l + 2u + 1 (u < P/2) of a slot row from the tile that holds them.
The replica must read every slot-row point exactly once, by the lane and
register step C expects, and equal the workspace design's replica
(``test_torch_long_rows_radix.k3_long_schedule``, the same per-value
arithmetic) value for value at both n1, every cluster size and both tile
widths.
"""

import numpy as np
import pytest

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_natural, fft_rows
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from test_torch_fft_natural_radix import radix_schedule, swizzle
from test_torch_long_rows_radix import (
    PLANNED, _dif, _rows, _bitrev, ct_address, k3_long_schedule, long_tables,
)
from test_torch_mixed_radix import warp_forward_fft

cap_cpu_threads()

T = 1024  # threads a K7 cluster block
BANKS = 32
# W_4^e as the kernel applies it (exact): x·1, x·(−i), x·(−1), x·i
_WC = (lambda x: x, lambda x: x.imag - 1j * x.real, lambda x: -x, lambda x: -x.imag + 1j * x.real)


# -- K7 ---------------------------------------------------------------------


def k7_cluster_schedule(x: np.ndarray, counts: dict | None = None) -> np.ndarray:
    """The cluster K7 on complex64 rows ``x [rows, n]``, natural order.
    ``counts`` (if given) gets ``"writes"`` per bin and ``"reads"`` per
    (partner, element) of the gather."""
    rows, n = x.shape
    plan = fft_natural.cluster_plan(n)
    c, m = plan.c, plan.m
    pre = (plan.pre[:, 0] + 1j * plan.pre[:, 1]).astype(np.complex64).reshape(c - 1, m)
    x = x.astype(np.complex64)
    buffers = []
    for r in range(c):  # each block: the DIF stage, its sub-FFT, the store to its own buffer
        y = x[:, :m].copy()
        for s in range(1, c):
            y = y + _WC[(r * s % c) * (4 // c)](x[:, s * m:(s + 1) * m])
        if r:
            y = y * pre[r - 1]
        buf = np.full((rows, m), np.nan, np.complex64)
        buf[:, swizzle(np.arange(m))] = radix_schedule(y)  # store_shared: bin k at word swizzle(k)
        buffers.append(buf)
    out = np.full((rows, n), np.nan, np.complex64)
    writes = np.zeros(n, np.int64)
    reads = np.zeros((c, m), np.int64)
    t = np.arange(T)
    for r in range(c):  # the gather: block r, thread t, bin g = r·m + t + T·i
        for i in range(m // T):
            g = r * m + t + T * i
            src, k = t % c, r * (m // c) + t // c + (T // c) * i
            assert (g == c * k + src).all()
            for s in range(c):
                sel = src == s
                out[:, g[sel]] = buffers[s][:, swizzle(k[sel])]
                np.add.at(reads[s], k[sel], 1)
            np.add.at(writes, g, 1)
    if counts is not None:
        counts.update(writes=writes, reads=reads)
    return out


@pytest.mark.parametrize("n", [32_768, 65_536])
def test_k7_cluster_replica_equals_numpy_fft(n):
    x = _rows(n, n + 1)
    counts = {}
    ours = k7_cluster_schedule(x, counts)
    ref = np.fft.fft(x.astype(np.complex128))
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()
    np.testing.assert_array_equal(counts["writes"], 1)  # every output bin written exactly once
    np.testing.assert_array_equal(counts["reads"], 1)  # every partner element read exactly once


@pytest.mark.parametrize("n", [32_768, 65_536])
def test_k7_cluster_gather_reads_distinct_banks_of_each_buffer(n):
    """A warp's gather reads 32/c consecutive elements of each partner's
    buffer; swizzled, they sit in distinct banks of that partner. The
    store of the last pass (32 consecutive bins a warp) is conflict-free."""
    c, m = fft_natural.cluster_plan(n).c, fft_natural.CLUSTER_SUB_N
    for r in range(c):
        for w in range(T // 32):
            t = 32 * w + np.arange(32)
            for i in range(m // T):
                k = r * (m // c) + t // c + (T // c) * i
                for s in range(c):
                    words = swizzle(k[t % c == s])
                    assert len(set(words % BANKS)) == len(words)
    t = np.arange(32)
    assert len(set(swizzle(t + T * 5) % BANKS)) == 32


def test_k7_cluster_plan_tables_are_float64_roots_rounded_once():
    for n in fft_natural.CLUSTER_N:
        plan = fft_natural.cluster_plan(n)
        assert (plan.c, plan.m) == (n // 16384, 16384) and plan.pre.dtype == np.float32
        e = np.outer(np.arange(1, plan.c), np.arange(plan.m)).reshape(-1)
        w = np.exp(-2j * np.pi * e / n)
        np.testing.assert_array_equal(plan.pre[:, 0], w.real.astype(np.float32))
        np.testing.assert_array_equal(plan.pre[:, 1], w.imag.astype(np.float32))
    with pytest.raises(ValueError):
        fft_natural.cluster_plan(16384)


# -- K3 ---------------------------------------------------------------------


def _steps_ab(tile, a, r, w128, wn2, wr, tw_cols):
    """Steps A and B in place on ``tile [rows, n2, cols]`` (the workspace
    replica's arithmetic, written back to the tile)."""
    rows, _, cols = tile.shape
    abits = a.bit_length() - 1
    for j in range(r):
        v = _dif([tile[:, j + r * u].copy() for u in range(a)], w128, 128)
        for u in range(a):
            k = _bitrev(u, abits)
            tile[:, j + r * k] = v[u] * wn2[j * k] if k else v[u]
    for k in range(a):
        y = tile[:, r * k:r * (k + 1)].copy()
        for s in range(r):
            acc = np.zeros((rows, cols), np.complex64)
            for j in range(r):
                acc += wr[j, s] * y[:, j]
            tile[:, s + r * k] = acc * tw_cols[k + a * s]


def k3_cluster_schedule(x: np.ndarray, reads: list | None = None) -> np.ndarray:
    """The cluster K3 on complex64 rows ``x [rows, n]``, CT order.
    ``reads`` (if given) gets, per block, the count of row-pass reads of
    each ``[tile, slot row, column]`` element of its shared memory."""
    rows, n = x.shape
    g = fft_rows.long_geometry(n)
    n1, n2, a, r, c, cols = g.n1, g.n2, g.a, g.r, g.c, g.cols
    _, _, w1, wn2, wr, tw = long_tables(n1, n2)
    w128 = w1[:: n1 // 128]
    own, tiles, per, pp = n1 // c, n1 // c // cols, n2 // c, n1 // 32
    flat = x.astype(np.complex64)
    smem = []
    for rank in range(c):  # the columns: load, then steps A and B in place on each tile
        q = np.arange(n2)[:, None]
        xs = np.empty((rows, tiles, n2, cols), np.complex64)
        for t in range(tiles):
            p0 = rank * own + t * cols
            xs[:, t] = flat[:, q * n1 + p0 + np.arange(cols)[None, :]]
            _steps_ab(xs[:, t], a, r, w128, wn2, wr, tw[:, p0:p0 + cols])
        smem.append(xs)
    counts = [np.zeros((tiles, n2, cols), np.int64) for _ in range(c)]
    gathered = np.full((rows, n2, 32, pp), np.nan, np.complex64)
    for rank in range(c):  # the rows: block rank's slot rows, lane l's positions P·l + 2u (+1)
        for sr in range(rank * per, (rank + 1) * per):
            for lane in range(32):
                for u in range(pp // 2):
                    p = pp * lane + 2 * u
                    owner, col = divmod(p, own)
                    t, pc = divmod(col, cols)
                    assert pc + 1 < cols  # a 16-byte load never crosses a tile or a block
                    gathered[:, sr, lane, 2 * u:2 * u + 2] = smem[owner][:, t, sr, pc:pc + 2]
                    counts[owner][t, sr, pc:pc + 2] += 1
    assert not np.isnan(gathered).any()
    if reads is not None:
        reads.extend(counts)
    v = warp_forward_fft(gathered, n1)  # register i of lane l holds bin digit(i)·32 + brev5(l)
    out = np.full((rows, n), np.nan, np.complex64)
    for lane in range(32):
        for i in range(pp):
            m = np.array([ct_address(sr, i, lane, n1, a, r) for sr in range(n2)])
            out[:, m] = v[:, :, lane, i]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("n", [
    17_408,   # 128·136, c 2 (a length the one-block design takes too)
    24_576,   # 128·192, c 2
    33_792,   # 128·264, c 4, the flagship at block_len 32768
    34_816,   # 256·136, c 4, n1 = 256
    50_176,   # 128·392, c 4, r 49
    66_560,   # 128·520, c 8, 16-column tiles
])
def test_k3_cluster_replica_equals_workspace_replica(n):
    x = _rows(n, n + 3)
    reads = []
    ours = k3_cluster_schedule(x, reads)
    n1, n2 = ct_plan.ct_split(n)
    np.testing.assert_array_equal(ours, k3_long_schedule(x, n1, n2))
    for block in reads:  # every slot-row point read exactly once
        np.testing.assert_array_equal(block, 1)


STEP_B_OWNERS_PER_K = {32: 8, 16: 16}  # step_b_tile's owners of a column block, by tile width


def test_cluster_size_fits_every_planned_length():
    """For every planned nfft the long design takes with n1 = 128 or 256
    (and the lengths the card tests force onto it), c ≤ 8 is the least of
    2, 4, 8 for which two blocks fit one SM's 228 KB, else the least whose
    block fits 227 KB; n1/c is a multiple of the tile, and step B's owners
    cover r. The lengths with n1 = 384, 640 and 896 take the wide design
    (8 blocks)."""
    fits2 = lambda g, c: 2 * (fft_rows.cluster_smem(g.n1, g.n2, c) + 1024) <= 233_472
    for n in [17_408, 24_576] + [n for n in PLANNED if n > fft_rows.MAX_N]:
        g = fft_rows.long_geometry(n)
        if g.n1 > 256:
            assert (g.design, g.c) == ("wide", 8), n
            continue
        smem = fft_rows.cluster_smem(g.n1, g.n2, g.c)
        assert g.design == "cluster" and g.c <= 8 and smem <= fft_rows.SMEM_LIMIT == 232_448, n
        if fits2(g, g.c):
            assert not any(fits2(g, c) for c in (2, 4) if c < g.c), n
        else:
            assert all(fft_rows.cluster_smem(g.n1, g.n2, c) > 232_448 for c in (2, 4) if c < g.c), n
        assert (g.n1 // g.c) % g.cols == 0 and g.n2 % g.c == 0 and g.cols in (16, 32), n
        assert g.cols == 32 or g.n2 > 512 or (g.n1 // g.c) % 32, n
        assert g.r <= 2 * 4 * STEP_B_OWNERS_PER_K[g.cols], n  # step B holds every output of a round
    want = {17_408: 2, 33_792: 4, 34_816: 4, 66_560: 8, 115_712: 4, 131_072: 8}
    assert {n: fft_rows.long_geometry(n).c for n in want} == want
    assert fft_rows.cluster_smem(128, 904, 4) == 231_936 and fft_rows.cluster_smem(256, 512, 8) == 131_584
