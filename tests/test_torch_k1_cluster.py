"""The wide design of kernel K1 at n1 = 384, 640 and 896
(``csrc/fft_detect_cluster.cuh``, a template on n1 = 128·q, q = 3, 5, 7),
and so of the long K3 there (the same kernel without its detect half),
replayed in numpy on the CPU. No JAX here.

A row of n = n1·n2 samples (n2 = 8·r) is a thread-block cluster of C = 8
blocks of 512 threads:

- columns: block ``rank`` loads columns [OWN·rank, OWN·rank + OWN), OWN =
  n1/8 = 16·q, a (column, j) at a time into registers, runs step A on them
  and step B in rounds of whole column blocks, an item a thread (4
  outputs s = 4·sq .. 4·sq + 3 of four columns), in place;
- rows: after a cluster barrier it takes slot rows rank·r + s (s < r),
  lane l gathering positions q·l + 32q·g + u (register q·g + u) from
  block 2·g + l // 16, runs step C in that layout (two stages in
  registers, the others after trading a lane bit for a register digit;
  ``row_fft_replica``) and stores CT row k2 = rank + 8·s; ``pw[s][k1]``
  keeps their power;
- floor: block 0's rows are the CT rows k2 ≡ 0 (mod 8), the stride-8
  natural subsample, so it finds the floor alone (``floor_by_selection``:
  one order statistic, or ``rm_det::bisect_floor`` for a bucket of ties);
- detect: blocks 1 .. 7 (56, 92 or 128 columns each, the last 48, 88 or
  128; block 0 takes none while it finds the floor) pull, for their
  columns and every k2, the power from block k2 mod 8, with ``radius``
  halo bins of the neighbour columns (circular), in natural order; 4 bins
  a lane, the sliding max, the gates (the confidence gate last, on each
  segment's best), the segment partials over a lane pair.

Checks, at every n1: the replica's spectra equal the workspace design's
replica (``test_torch_long_rows_radix.k3_long_schedule``) value for value,
every slot-row point read once; the detect replica equals
``fft_detect.detect_plain`` exactly on float32 spectra (every step is a
max, a min, a count or a float32 comparison), every power pulled once; a
wrong owner or a wrong wrap disagrees; the geometry fits every planned
length with these n1.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_rows
from radio_mapper_tpu_torch.ops.cuda import fft_detect
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from test_torch_cluster_fft import _steps_ab
from test_torch_cuda import DET
from test_torch_fft_radix import _bitrev
from test_torch_long_rows_radix import (
    MIXED_SET, NO_NOTCH, PLANNED, _planted_spectra, _rows, k3_long_schedule, long_tables,
)
from test_torch_mixed_radix import _c64, digit_inv, q_dfts, q_roots, warp_forward_fft

cap_cpu_threads()

C, THREADS, SEG = 8, 512, 8
WIDE_N1 = (384, 640, 896)


def own(n1: int) -> int:
    """Columns a block: n1/8 = 16·q."""
    return n1 // C


def dcols(n1: int) -> int:
    """Detect columns of blocks 1 .. 6 (a multiple of 4): 56, 92, 128."""
    return 4 * -(-n1 // 28)


def detect_columns(rank: int, n1: int = 384):
    """The detect columns ``(first, count)`` of block ``rank``."""
    if rank == 0:
        return 0, 0
    d = dcols(n1)
    return d * (rank - 1), d if rank < C - 1 else n1 - d * (C - 2)


WIDE_LENGTHS = [n for n in PLANNED if ct_plan.ct_split(n)[0] == 384]
# the planned lengths with n1 = 640 (nfft 87040, 97280 = block_len 96000 at
# max_lag 600, 117760, 128000) and 896 (121856)
WIDE_LENGTHS_MIXED = [n for n in PLANNED if ct_plan.ct_split(n)[0] in (640, 896)]


def step_b_rounds(r: int, n1: int = 384):
    """The kernel's step-B schedule for r: ``[(k0, kr, items)]`` rounds,
    the items ``(thread, k, sq, p)`` of each: outputs 4·sq .. 4·sq + 3 of
    columns p, p + 1, p + OWN/2, p + OWN/2 + 1 of column block k, one a
    thread."""
    qpairs = own(n1) // 4
    rq = -(-r // 4)
    per_k = rq * qpairs
    kr = 8
    while kr > 1 and kr * per_k > THREADS:
        kr //= 2
    rounds = []
    for k0 in range(0, 8, kr):
        items = []
        for u in range(kr * per_k):
            ku, rem = divmod(u, per_k)
            sq, pp = divmod(rem, qpairs)
            items.append((u, k0 + ku, sq, 2 * pp))
        rounds.append((k0, kr, items))
    return rounds


def wide_k3_schedule(x: np.ndarray, reads: list | None = None, owner=None) -> np.ndarray:
    """The wide K3 on complex64 rows ``x [rows, n]``, CT order. ``reads``
    (if given) gets, per block, the count of step C's uses of each ``[slot
    row, column]`` of its shared memory; ``owner`` maps a row position to
    the block it is read from (by default position // OWN)."""
    rows, n = x.shape
    g = fft_rows.long_geometry(n)
    n1, n2, a, r = g.n1, g.n2, g.a, g.r
    OWN, qd, P = own(n1), n1 // 128, n1 // 32
    owner = owner or (lambda pos: pos // OWN)
    _, _, w1, wn2, wr, tw = long_tables(n1, n2)
    w128 = w1[:: n1 // 128]
    flat = x.astype(np.complex64)
    q = np.arange(n2)[:, None]
    smem = []
    for rank in range(C):  # the columns: load, then steps A and B in place
        c0 = rank * OWN
        xs = flat[:, q * n1 + c0 + np.arange(OWN)[None, :]]
        _steps_ab(xs, a, r, w128, wn2, wr, tw[:, c0:c0 + OWN])
        smem.append(xs)
    counts = [np.zeros((n2, OWN), np.int64) for _ in range(C)]
    gathered = np.full((rows, n2, 32, P), np.nan, np.complex64)
    pos = layout_positions(qd)  # lane l, register j: position q·l + 32q·(j // q) + j mod q
    blocks, cols = owner(pos), pos % OWN
    for sr in range(n2):  # block sr // r takes slot row sr
        for b in range(C):
            sel = blocks == b
            gathered[:, sr][:, sel] = smem[b][:, sr, cols[sel]]
            np.add.at(counts[b][sr], cols[sel], 1)
    assert not np.isnan(gathered).any()
    if reads is not None:
        reads.extend(counts)
    v = row_fft_replica(gathered, n1)  # register j of lane l holds bin (j // q + 4·(j mod q))·32 + brev5(l)
    j = np.arange(P)
    k1 = (j // qd + 4 * (j % qd))[None, :] * 32 + np.array([_bitrev(lane, 5) for lane in range(32)])[:, None]
    out = np.full((rows, n), np.nan, np.complex64)
    for sr in range(n2):
        rank, s = divmod(sr, r)
        out[:, (rank + 8 * s) * n1 + k1] = v[:, sr]  # CT row k2 = rank + 8·s
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("n", [
    52_224,   # 384·136, r 17, the shortest n1 = 384 length
    58_368,   # 384·152, r 19, the flagship at block_len 57344
    101_376,  # 384·264, r 33: step B in four rounds of two column blocks, one block an SM
    87_040,   # 640·136, r 17: P = 20, step B in two rounds of four column blocks
    97_280,   # 640·152, r 19, the flagship at block_len 96000
    128_000,  # 640·200, r 25: four rounds of two column blocks
    121_856,  # 896·136, r 17: P = 28, four rounds of two column blocks
])
def test_wide_k3_replica_equals_workspace_replica(n):
    x = _rows(n, n + 5)
    reads = []
    ours = wide_k3_schedule(x, reads)
    n1, n2 = ct_plan.ct_split(n)
    np.testing.assert_array_equal(ours, k3_long_schedule(x, n1, n2))
    for block in reads:  # every slot-row point read exactly once
        np.testing.assert_array_equal(block, 1)


@pytest.mark.parametrize("n", [52_224, 87_040, 121_856])
def test_wide_k3_replica_with_a_wrong_owner_disagrees(n):
    x = _rows(n, 3)
    n1, n2 = ct_plan.ct_split(n)
    bad = wide_k3_schedule(x, owner=lambda pos: (pos // own(n1) + 1) % C)
    assert not np.array_equal(bad, k3_long_schedule(x, n1, n2))


@pytest.mark.parametrize("n", WIDE_LENGTHS + WIDE_LENGTHS_MIXED)
def test_step_b_rounds_cover_each_output_once(n):
    """Each round takes whole column blocks and at most one item a thread;
    together the rounds write every (column block, output, column) once."""
    n1, n2 = ct_plan.ct_split(n)
    r, OWN = n2 // 8, own(n1)
    seen = np.zeros((8, r, OWN), np.int64)
    for k0, kr, items in step_b_rounds(r, n1):
        assert {k for _, k, _, _ in items} == set(range(k0, k0 + kr))
        assert max(t for t, *_ in items) < THREADS
        for _, k, sq, p in items:
            for e in range(4):
                if 4 * sq + e < r:
                    for col in (p, p + 1, p + OWN // 2, p + OWN // 2 + 1):
                        seen[k, 4 * sq + e, col] += 1
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("c", [2, 4, 8, 16])
def test_block_0_holds_the_stride_8_subsample_only_at_c_8(c):
    """Block 0 of a cluster of c blocks takes slot rows [0, n2/c), CT rows
    k2 = k + 8·s (k = sr // r, s = sr mod r): at c = 8 exactly the CT rows
    k2 ≡ 0 (mod 8), the noise floor's subsample; at any other c not."""
    n2 = 152
    r = n2 // 8
    rows = {(sr // r) + 8 * (sr % r) for sr in range(n2 // c)}
    assert (rows == set(range(0, n2, 8))) == (c == 8)


# step C's register layout: register j = u + q·g of lane l holds row
# position q·l + 32q·g + u (u < q, g < 4), so lane l's P = 4q positions lie
# in block 2·g + l // 16, columns q·(l mod 16) + u
def layout_positions(q: int = 3) -> np.ndarray:
    """``[32, 4q]``: the row position lane l, register j holds."""
    lanes, j = np.arange(32)[:, None], np.arange(4 * q)[None, :]
    return q * lanes + 32 * q * (j // q) + j % q


def row_stages(q: int):
    """The stages of step C (row_fft) for n1 = 128·q: (lane bit d exchanged
    with the register digit of weight wt, or d = 0 for a stage in
    registers; the W_n1 exponent of the pair whose top register is j0 in
    lane l; multiply at exponent 0 too)."""
    return [
        (0, 2 * q, lambda j0, l: j0 % q + 32 * q * (j0 // q) + q * l, True),  # h = 64q: b4 in registers
        (0, q, lambda j0, l: 2 * (j0 % q + q * l), True),  # h = 32q: b3
        (16, 2 * q, lambda j0, l: 4 * (j0 % q + q * (l & 15)), True),  # h = 16q: b2 in lane bit 4 <-> b4
        (8, q, lambda j0, l: 8 * (j0 % q + q * (l & 7)), True),  # h = 8q: b1 in lane bit 3 <-> b3
        (4, 2 * q, lambda j0, l: 16 * (j0 % q + q * (l & 3)), True),  # h = 4q: b0 in lane bit 2 <-> b2
        (2, q, lambda j0, l: 32 * (j0 % q + q * (l & 1)), False),  # the P-point part, h = 2q: i_hi <-> b1
        (1, 2 * q, lambda j0, l: 64 * (j0 % q) + 0 * l, False),  # h = q: i_mid <-> b0
    ]


ROW_STAGES = row_stages(3)


def row_fft_replica(v: np.ndarray, n1: int = 384, stages=None) -> np.ndarray:
    """``row_fft<n1>`` on registers ``v [..., 32, P]`` in the layout above:
    each stage pairs registers j0, j0 + wt (after an exchange of the
    register digit of weight wt with lane bit d: lanes with the bit set
    send the digit-0 half and take the partner's digit-1 half) and runs the
    butterfly (a + b, (a − b)·W_n1^e), then the q-point DFTs of
    ``q_dfts``. Register j of lane l then holds bin (j // q + 4·(j mod q))·32
    + brev5(l)."""
    q, half = n1 // 128, n1 // 2
    stages = stages or row_stages(q)
    w1 = _c64(ct_plan._roots(np.arange(half), n1))
    v = v.copy()
    lanes = np.arange(32)
    for d, wt, index, always in stages:
        bit = (lanes & d) != 0
        for j0 in [j for j in range(4 * q) if (j // wt) % 2 == 0]:
            j1 = j0 + wt
            a, b = v[..., j0].copy(), v[..., j1].copy()
            if d:
                recv = np.where(bit, a, b)[..., lanes ^ d]
                a, b = np.where(bit, recv, a), np.where(bit, b, recv)
            e = index(j0, lanes)
            assert e.min() >= 0 and e.max() < half
            diff = a - b
            v[..., j0] = a + b
            v[..., j1] = np.where(always | (e != 0), diff * w1[e], diff)
    return q_dfts(v, q_roots(q, w1, n1))


@pytest.mark.parametrize("n1", WIDE_N1)
def test_row_fft_replica_equals_step_c_value_for_value(n1):
    """The register-layout step C gives step_c_regs<n1>'s outputs value for
    value (the same butterflies, twiddles and order), each in the register
    the layout names; a wrong exchange partner disagrees."""
    q, P = n1 // 128, n1 // 32
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(6, n1)) + 1j * rng.normal(size=(6, n1))).astype(np.complex64)
    ref = warp_forward_fft(x.reshape(6, 32, P), n1)  # register i of lane l: bin digit(i)·32 + brev5(l)
    ours = row_fft_replica(x[:, layout_positions(q)], n1)
    j = np.arange(P)
    np.testing.assert_array_equal(ours, ref[..., [digit_inv(P, dj) for dj in j // q + 4 * (j % q)]])
    bad = [(d ^ 1 if d > 1 else d, *rest) for d, *rest in row_stages(q)]
    assert not np.array_equal(row_fft_replica(x[:, layout_positions(q)], n1, bad), ours)
    # lane l's positions: block 2·g + l // 16, columns q·(l mod 16) + u
    pos = layout_positions(q)
    assert np.array_equal(pos // own(n1), 2 * (np.arange(P)[None, :] // q) + np.arange(32)[:, None] // 16)
    assert np.array_equal(pos % own(n1), q * (np.arange(32)[:, None] % 16) + np.arange(P)[None, :] % q)


@pytest.mark.parametrize("n1", WIDE_N1)
def test_step_c_gather_reads_whole_16_byte_words_of_its_block(n1):
    """Lane l's q values of register group g start at column q·(l mod 16):
    on 16 bytes for even lanes, one float2 past it for odd ones (q odd), so
    the kernel loads (q + 1)/2 16-byte words from the even column at or
    below and an odd lane drops the first value. Those words lie inside
    the block's OWN columns and cover the lane's q columns."""
    q = n1 // 128
    loads = (q + 1) // 2
    for lane in range(32):
        first = q * (lane % 16)
        start = first - (lane & 1)
        assert start % 2 == 0 and start >= 0 and start + 2 * loads <= own(n1), lane
        got = [start + (lane & 1) + u for u in range(q)]  # f[u + odd] of the loaded float2s
        assert got == list(range(first, first + q)), lane


def row_twiddle_exponents(q: int = 3) -> np.ndarray:
    """The kernel's ``rts`` table (``row_tw_exponent``): the W_n1 exponent
    of each entry, a stage, a u (at h = 64q a g too) and a lane class
    apart: h = 64q [g·q + u][l]; 32q [u][l]; 16q [u][l mod 16]; 8q [u][l
    mod 8]; 4q [u][l mod 4]; 2q [u][l mod 2]."""
    out = [u + 32 * q * g + q * lane for g in range(2) for u in range(q) for lane in range(32)]
    lanes, scale = 32, 2
    while lanes >= 2:
        out += [scale * (u + q * lane) for u in range(q) for lane in range(lanes)]
        lanes, scale = lanes // 2, scale * 2
    return np.array(out)


@pytest.mark.parametrize("n1", WIDE_N1)
def test_row_twiddle_table_holds_step_c_twiddles_in_distinct_banks(n1):
    """Every twiddle of row_fft's stages at h = 64q .. 2q (``row_stages``)
    is the table entry the kernel reads for that pair and lane (each below
    n1/2), and a warp's reads of one pair are consecutive float2s (at most
    32: two wavefronts) or broadcasts."""
    q = n1 // 128
    table = row_twiddle_exponents(q)
    assert table.shape == (126 * q,) and table.max() < n1 // 2
    assert (n1 // 2 + table.size) * 8 == fft_rows.wide_table_bytes(n1)
    lanes = np.arange(32)
    offsets = (0, 64 * q, 96 * q, 112 * q, 120 * q, 124 * q)
    for stage, (d, wt, index, _) in enumerate(row_stages(q)[:6]):
        for j0 in [j for j in range(4 * q) if (j // wt) % 2 == 0]:
            if stage == 0:
                idx = j0 * 32 + lanes
            elif stage == 1:
                idx = 64 * q + j0 % q * 32 + lanes
            else:
                idx = offsets[stage] + j0 % q * d + (lanes & (d - 1))
            np.testing.assert_array_equal(table[idx], index(j0, lanes))
            distinct = np.unique(idx)
            assert np.all(np.diff(distinct) == 1) and len(distinct) == (32 if stage < 2 else d)


NB, CAND = 1024, THREADS  # the floor's histogram buckets; the values its selection ranks, one a thread


def bisect_floor(db: np.ndarray, iters: int) -> np.float32:
    """``rm_det::bisect_floor`` on one row's float32 dB values: the min and
    max of the values that are not NaN (fminf, fmaxf), then ``iters``
    steps of mid = 0.5·(lo + hi), lo = mid where 2·count(db ≤ mid) < s."""
    ok = ~np.isnan(db)
    lo = db[ok].min() if ok.any() else np.float32(np.inf)
    hi = db[ok].max() if ok.any() else np.float32(-np.inf)
    for _ in range(iters):
        mid = np.float32(0.5) * (lo + hi)
        if 2 * np.count_nonzero(db <= mid) < db.size:
            lo = mid
        else:
            hi = mid
    return np.float32(0.5) * (lo + hi)


def floor_by_selection(db: np.ndarray, iters: int):
    """The wide K1's ``floor_select`` on one row's float32 dB values:
    ``(floor, path)``. Every bisection step asks whether fewer than k =
    (s + 1)/2 values are ≤ mid, that is mid < T for T the k-th smallest;
    a histogram of [lo, hi] in NB buckets finds T's bucket and its values
    are ranked ("select"); fewer than k values not NaN make every step
    below ("absent"); a bucket of more than CAND values takes the
    bisection ("bisect")."""
    s, k = db.size, (db.size + 1) // 2
    ok = ~np.isnan(db)
    lo = db[ok].min() if ok.any() else np.float32(np.inf)
    hi = db[ok].max() if ok.any() else np.float32(-np.inf)
    mid = lambda a, b: np.float32(0.5) * (a + b)
    if np.count_nonzero(ok) < k:
        for _ in range(iters):
            lo = mid(lo, hi)
        return mid(lo, hi), "absent"
    scale = np.float32(NB) / (hi - lo) if hi > lo else np.float32(0.0)
    bucket = np.minimum(NB - 1, ((db[ok] - lo) * scale).astype(np.int64))
    cum = np.cumsum(np.bincount(bucket, minlength=NB))
    bstar = int(np.searchsorted(cum, k))  # the first bucket whose running count reaches k
    kk = k - 1 - (cum[bstar - 1] if bstar else 0)
    cand = db[ok][bucket == bstar]
    if cand.size > CAND:
        return bisect_floor(db, iters), "bisect"
    t = np.sort(cand)[kk]
    for _ in range(iters):
        m0 = mid(lo, hi)
        if np.isnan(m0) or m0 < t:
            lo = m0
        else:
            hi = m0
    return mid(lo, hi), "select"


@pytest.mark.parametrize("case", ["noise", "tone", "ties", "halves", "odd", "nan", "constant", "all-nan"])
def test_floor_by_selection_equals_the_bisection(case):
    """The floor from one order statistic equals the 24-step bisection bit
    for bit: on noise (with a tone), on rows of few distinct values, an odd
    count, NaN values; a row of equal values takes the bisection itself."""
    rng = np.random.default_rng(len(case))
    s = 7295 if case == "odd" else 7296
    db = (10 * np.log10(rng.exponential(size=s)) + 42.1).astype(np.float32)
    if case == "tone":
        db[::97] += np.float32(40.0)
    if case == "ties":
        db = np.round(db, 1).astype(np.float32)
    if case == "halves":
        db = np.where(np.arange(s) % 2 == 0, np.float32(40.0), np.float32(43.0)).astype(np.float32)
    if case == "nan":
        db[::5] = np.nan
    if case == "constant":
        db[:] = np.float32(-197.9)
    if case == "all-nan":
        db[:] = np.nan
    with np.errstate(invalid="ignore"):  # all NaN: lo + hi = inf − inf
        got, path = floor_by_selection(db, 24)
        want = bisect_floor(db, 24)
    assert (got == want) or (np.isnan(got) and np.isnan(want)), (got, want)
    assert path == {"constant": "bisect", "halves": "bisect", "all-nan": "absent"}.get(case, "select"), path


def slot_powers(pr: np.ndarray, n1: int, n2: int, c: int) -> np.ndarray:
    """Each block's ``pw`` after step C in a cluster of c blocks: ``[c,
    rows, n2/c, n1]``, block ``rank`` holding slot rows [rank·n2/c,
    (rank+1)·n2/c), slot row sr = k·r + s being CT row k2 = k + 8·s (at c
    = 8, the wide design's: block k2 mod 8, row k2/8)."""
    rows = pr.shape[0]
    r, per = n2 // 8, n2 // c
    sr = np.arange(n2)
    return pr.reshape(rows, n2, n1)[:, sr // r + 8 * (sr % r), :].reshape(rows, c, per, n1).transpose(1, 0, 2, 3)


def power_at(k2: np.ndarray, n2: int, c: int):
    """The block and row of ``pw`` that hold CT row k2: block (k2 mod 8)/(8/c),
    row ((k2 mod 8) mod (8/c))·r + k2/8."""
    g, r = 8 // c, n2 // 8
    return (k2 % 8) // g, ((k2 % 8) % g) * r + k2 // 8


def cluster_detect_replica(fr, fi, plan, c, columns, owner=None, wrap=True, pulls=None):
    """A cluster K1's detect half on float32 CT-order spectra ``[rows, n]``
    (the wide design at c = 8, the cluster design at n1 = 128/256 at c =
    2, 4, 8): ``(seg_score, seg_arg, noise_floor_db, row_max)``. Block 0's
    first r rows of ``pw`` are the subsample, whose floor it finds;
    ``columns(rank)`` gives each block's detect columns ``(first, count)``.
    ``owner`` (k2 → block) replaces the pull's block; ``wrap`` takes the
    halo circularly (k1 = n1 − 1 before 0, 0 after n1 − 1); ``pulls`` gets
    each block's count of reads of its ``pw[row][k1]``, halos apart."""
    rows, n = fr.shape
    n1, n2, rad = plan.n1, plan.n2, plan.radius
    r = n2 // 8
    pr = (fr * fr + fi * fi).astype(np.float32)  # rm_det::power: two products, one sum, float32
    ct = pr.reshape(rows, n2, n1)
    pw = slot_powers(pr, n1, n2, c)
    row_max = pw.max(axis=(2, 3)).max(axis=0)  # each block's max, then over the cluster
    sub = pw[0][:, :r, :].reshape(rows, -1)  # block 0's first r rows: the stride-8 subsample
    np.testing.assert_array_equal(np.sort(sub, axis=-1),
                                  np.sort(ct[:, (np.arange(n2) % 8) == 0, :].reshape(rows, -1), axis=-1))
    db = (10.0 * torch.log10(torch.from_numpy(sub) + 1e-24) + plan.power_offset_db).numpy()
    nf = np.array([floor_by_selection(d, plan.bisect_iters)[0] for d in db], np.float32)
    conf = None
    if plan.conf_cs is not None:
        conf = torch.exp((torch.from_numpy(nf) - plan.power_offset_db + plan.conf_cs) * ct_plan.LN10_OVER_10).numpy()
    score = np.full((rows, n // SEG), np.nan, np.float32)
    arg = np.full((rows, n // SEG), np.nan, np.float32)
    counts = np.zeros((c, n2 // c, n1), np.int64)
    for rank in range(c):
        c0, dn = columns(rank)
        if dn == 0:
            continue
        nat = np.full((rows, dn * n2 + 2 * rad), np.nan, np.float32)
        u = np.arange(n2 * (dn // 4))
        qd, k2 = u // n2, u % n2  # consecutive threads, consecutive k2
        blocks, local = power_at(k2, n2, c)
        if owner is not None:
            blocks = owner(k2)
        for e in range(4):
            k1 = c0 + 4 * qd + e
            nat[:, rad + (4 * qd + e) * n2 + k2] = pw[blocks, :, local, k1].T
            np.add.at(counts, (blocks, local, k1), 1)
        left = (n1 - 1 if c0 == 0 else c0 - 1) if wrap else max(c0 - 1, 0)
        right = (0 if c0 + dn == n1 else c0 + dn) if wrap else min(c0 + dn, n1 - 1)
        h = np.arange(rad)
        nat[:, h] = ct[:, n2 - rad + h, left]
        nat[:, dn * n2 + rad + h] = ct[:, h, right]
        assert not np.isnan(nat).any()
        win = np.lib.stride_tricks.sliding_window_view(nat, 2 * rad + 1, axis=-1).max(axis=-1)
        p = nat[:, rad:rad + dn * n2]
        b = np.arange(dn * n2)
        cc, kk2 = b // n2, b % n2
        k = kk2 + n2 * (c0 + cc)
        pe = p + np.float32(1e-24)
        cand = (p >= win) & (pe > np.float32(plan.thr_lin)) & (k >= plan.keep_lo) & (k <= plan.keep_hi)
        sc = np.where(cand, p, np.float32(-np.inf)).astype(np.float32).reshape(rows, dn * n2 // SEG, SEG)
        best = sc.max(axis=-1)  # a lane pair: 4 bins each
        first = np.where(sc >= best[..., None], np.arange(SEG), SEG).min(axis=-1).astype(np.float32)
        if conf is not None:  # the confidence gate on each segment's best
            keep = best + np.float32(1e-24) >= conf[:, None]
            best, first = np.where(keep, best, np.float32(-np.inf)), np.where(keep, first, np.float32(0))
        g = np.arange(dn * n2 // SEG)
        gc, gb2 = (g * SEG) // n2, ((g * SEG) % n2) // SEG
        f = gb2 * n1 + c0 + gc
        score[:, f] = best
        arg[:, f] = first
    assert not (np.isnan(score).any() or np.isnan(arg).any())
    if pulls is not None:
        pulls.extend(counts)
    return score, arg, nf, row_max


def wide_detect_replica(fr: np.ndarray, fi: np.ndarray, plan: ct_plan.DetectPlan, owner=lambda k2: k2 % 8,
                        wrap=True, pulls: list | None = None):
    """The wide K1's detect half (:func:`cluster_detect_replica` at c = 8,
    block k2 mod 8 holding CT rows k2 in its rows k2/8, the detect columns
    of :func:`detect_columns`)."""
    return cluster_detect_replica(fr, fi, plan, C, lambda rank: detect_columns(rank, plan.n1), owner, wrap, pulls)


@pytest.mark.parametrize("n,radius,notch", [
    (52_224, 10, True),
    (58_368, 10, True),    # the flagship at block_len 57344
    (58_368, 152, False),  # radius = n2: a whole neighbour column is the halo
    (101_376, 33, False),
    (87_040, 10, True),    # n1 = 640: 92 detect columns a block, 88 the last
    (97_280, 10, True),    # the flagship at block_len 96000
    (97_280, 152, False),
    (128_000, 25, False),
    (121_856, 10, True),   # n1 = 896: 128 detect columns a block
    (121_856, 136, False),
])
def test_wide_detect_replica_equals_plain_detect(n, radius, notch):
    plan = ct_plan.detect_plan(n, **{**DET, "min_distance_bins": radius, **({} if notch else NO_NOTCH)})
    fr, fi = _planted_spectra(plan, n + radius)
    pulls = []
    ours = wide_detect_replica(fr, fi, plan, pulls=pulls)
    ref = fft_detect.detect_plain(torch.from_numpy(fr), torch.from_numpy(fi), plan)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r.numpy())
    for block in pulls:  # every power pulled exactly once, halos apart
        np.testing.assert_array_equal(block, 1)
    # the planted block-edge peaks (every OWN columns is a 16-column tile edge)
    # stand as candidates in row 2
    seg_of = lambda k1, k2: (k2 // 8) * plan.n1 + k1
    for c0 in range(0, plan.n1, own(plan.n1)):
        if plan.keep_lo <= plan.n2 * c0 <= plan.keep_hi:
            assert np.isfinite(ours[0][2, seg_of(c0, 0)])


@pytest.mark.parametrize("n", [58_368, 97_280, 121_856])
@pytest.mark.parametrize("mutant", ["owner", "wrap"])
def test_wide_detect_replica_with_a_wrong_owner_or_wrap_disagrees(mutant, n):
    plan = ct_plan.detect_plan(n, **{**DET, "min_distance_bins": 10, **NO_NOTCH})
    fr, fi = _planted_spectra(plan, 11)
    kw = {"owner": lambda k2: (k2 + 1) % 8} if mutant == "owner" else {"wrap": False}
    bad = wide_detect_replica(fr, fi, plan, **kw)
    ref = fft_detect.detect_plain(torch.from_numpy(fr), torch.from_numpy(fi), plan)
    assert not np.array_equal(bad[0], ref[0].numpy())


def test_wide_geometry_fits_every_planned_n1_384_length():
    """The 18 planned lengths with n1 = 384 (52224 ... 129024, n2 = 136 ...
    336) take the wide design: c = 8, 48 columns a block, shared memory
    within a block's 227 KB with the detect half; two blocks an SM up to
    70656 and one above (K3 alone up to 101376); the detect half's natural
    order, window overrun and staged partials fit the freed column buffer
    at any radius up to n2."""
    assert len(WIDE_LENGTHS) == 18 and WIDE_LENGTHS[0] == 52_224 and WIDE_LENGTHS[-1] == 129_024
    assert set(WIDE_LENGTHS) <= set(MIXED_SET)
    _check_wide_geometry(WIDE_LENGTHS)
    for n in WIDE_LENGTHS:
        g = fft_rows.long_geometry(n)
        assert 17 <= g.r <= 42, n
        assert fft_rows.wide_blocks(g.n1, g.n2, True) == (2 if n <= 70_656 else 1), n
        assert fft_rows.wide_blocks(g.n1, g.n2, False) == (2 if n <= 101_376 else 1), n
    assert fft_rows.wide_smem(384, 152, True) == 58_368 + 29_184 + 4_560
    assert sum(detect_columns(rank)[1] for rank in range(C)) == 384 and detect_columns(C - 1) == (336, 48)


def test_wide_geometry_fits_every_planned_n1_640_896_length():
    """The 5 planned lengths with n1 = 640 (87040, 97280, 117760, 128000)
    and 896 (121856) take the wide design: c = 8, 80 or 112 columns a
    block, r ≤ 25 within step B's one-round limit (100 at 640, 72 at 896),
    shared memory within a block's 227 KB with the detect half (135–197 KB
    with 7.4–10.4 KB of tables), one block an SM (launch bounds of 128
    registers), but two for K3 at 87040 and 97280, where two fit an SM's
    shared memory (launch bounds of 64); the detect columns (92 on blocks 1–6 and 88 on block 7 at
    640, 128 each at 896) are whole multiples of 4 and their natural
    order, window overrun and staged partials fit the freed column buffer
    at any radius up to n2. No planned length takes the workspace design."""
    assert WIDE_LENGTHS_MIXED == [87_040, 97_280, 117_760, 121_856, 128_000]
    assert set(WIDE_LENGTHS_MIXED) <= set(MIXED_SET)
    _check_wide_geometry(WIDE_LENGTHS_MIXED)
    for n in WIDE_LENGTHS_MIXED:
        g = fft_rows.long_geometry(n)
        assert g.r in (17, 19, 23, 25) and g.r <= fft_rows.wide_max_r(g.n1), n
        assert 135_000 <= fft_rows.wide_smem(g.n1, g.n2, True) <= 200_000, n
        assert fft_rows.wide_blocks(g.n1, g.n2, True) == 1, n
        two = n in (87_040, 97_280)  # K3 alone: 97,360 and 107,920 B a block
        assert fft_rows.wide_blocks(g.n1, g.n2, False) == 1 + two, n
    assert (fft_rows.wide_max_r(640), fft_rows.wide_max_r(896)) == (100, 72)
    assert (fft_rows.wide_table_bytes(640), fft_rows.wide_table_bytes(896)) == (7_600, 10_640)
    assert fft_rows.wide_smem(640, 152, True) == 97_280 + 48_640 + 7_600
    for n1, d, last in ((640, 92, 88), (896, 128, 128)):
        cols = [detect_columns(rank, n1) for rank in range(C)]
        assert cols[0] == (0, 0) and cols[1] == (0, d) and cols[C - 1][1] == last, n1
        assert sum(c for _, c in cols) == n1 and all(c % 4 == 0 for _, c in cols), n1
    assert {fft_rows.long_geometry(n).design for n in PLANNED if n > fft_rows.MAX_N} == {"cluster", "wide"}


def _check_wide_geometry(lengths):
    for n in lengths:
        g = fft_rows.long_geometry(n)
        assert (g.design, g.c, g.cols, g.a) == ("wide", 8, own(g.n1), 8), n
        assert g.r <= fft_rows.wide_max_r(g.n1), n
        for detect in (True, False):
            smem = fft_rows.wide_smem(g.n1, g.n2, detect)
            assert smem + fft_rows.WIDE_STATIC_BYTES <= fft_rows.SMEM_LIMIT, n
            blocks = fft_rows.wide_blocks(g.n1, g.n2, detect)
            fits2 = 2 * (smem + 256 + 1024) <= 233_472
            assert blocks == (2 if fits2 and (g.n1 == 384 or (g.n1 == 640 and not detect)) else 1), n
        bins = dcols(g.n1) * g.n2  # the most detect columns a block takes
        floats = -(-bins // 128) * 128 + 2 * g.n2 + 8 + 2 * g.r * dcols(g.n1)  # nat at radius n2, a warp's overrun, partials
        assert 4 * floats <= n, n  # the column buffer: n bytes
        assert 4 * (n // 8 + NB + CAND) <= n, n  # block 0's dB values, histogram and selected bucket
