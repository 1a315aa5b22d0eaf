"""The wide GCC pair body (n1 = 384, 640, 896) of kernels K2, K5 and K6,
replayed in numpy on the CPU.

``csrc/gcc_pair_wide.cuh`` (``wide_pair_body``) stages a tile's sources a
chunk of CT rows at a time in shared memory (one bulk copy a source
plane), runs the mixed-radix warp FFT of ``tests/test_torch_mixed_radix.py``
one (pair, row) job a warp, stores C = E·TW over the pair's leaf row at
``swz_wide(p, row)`` (XORs of p's low bits) and folds the window rows on
tensor cores:
per k-step of 4 rows, ``mma.sync.m16n8k8`` TF32 with A[p][(row, re|im)] =
C and B[(row, re|im)][(window row, re|im)] from W2, in the 3xTF32 split
(small·big + big·small + big·big, FP32 accumulation). Warp w owns m-tiles
w·n1/128 .. (w + 1)·n1/128 − 1 of each of its two accumulator slots.

Held here: the fragment map covers every (p, window row, k2) product
exactly once; the 3xTF32 fold stays within 1e-6 of a float64 fold at
58368 and 121856 (one TF32 product does not); the replica of the whole
body equals the plain version the kernels are held to (1e-5 of the window
max, same argmax) at every gate, with tiles of two pairs and with the
window split over blocks; the stores and the fold's reads are free of
bank conflicts; the double buffer fits shared memory at the widest
planned window (129024 = 384·336, max_lag 2048) and n1 = 384 keeps two
blocks an SM; K2's tiles cover every pair exactly once. No JAX here.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch.ops import ct_plan, gcc_phat
from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import correlated_spectra, pair_gate_scales
from test_torch_mixed_radix import inverse_times, warp_inverse_mixed

cap_cpu_threads()

WARP, WARPS, BANKS = 32, 8, 32
LANES = np.arange(WARP)
GID, TIG = LANES >> 2, LANES & 3  # mma fragment coordinates
WIDE = (384, 640, 896)
GATES = ("l2rx", "l2", "l1", "none")
SM_SHARED = 233_472  # the H100's shared memory an SM (228 KB)
SM_RESERVED = 1024  # the runtime's share a resident block


def swz_wide(p, rr, n1):
    """``rm_wide::swz_wide<P>``: where time p of C row rr sits in its row."""
    p = np.asarray(p)
    return (p ^ ((p // (8 * (n1 // WARP))) & 3)) ^ ((np.asarray(rr) & 3) << 3)


def tf32(x):
    """The TF32 value the tensor cores read from a float: its top 19 bits
    (sign, exponent, 10 mantissa bits); ``rm_wide::tf32_big``."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """``rm_wide::split_tf32``: x = big + small, small = x − big exactly
    (the tensor cores then read small's top 19 bits)."""
    big = tf32(x)
    return big, np.asarray(x, np.float32) - big


def mma(d, a, b):
    """``mma.sync.m16n8k8`` TF32 from the lanes' fragments: a [32, 4]
    (A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]), b [32, 2] (B[t][g],
    B[t+4][g]); d [32, 4] (D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1])
    accumulated in FP32; each operand read as TF32."""
    a, b = tf32(a), tf32(b)
    A = np.zeros((16, 8))
    A[GID, TIG], A[GID + 8, TIG], A[GID, TIG + 4], A[GID + 8, TIG + 4] = a.T.astype(np.float64)
    B = np.zeros((8, 8))
    B[TIG, GID], B[TIG + 4, GID] = b.T.astype(np.float64)
    D = A @ B
    prod = np.stack([D[GID, 2 * TIG], D[GID, 2 * TIG + 1], D[GID + 8, 2 * TIG], D[GID + 8, 2 * TIG + 1]], 1)
    return (d.astype(np.float64) + prod).astype(np.float32)


def b_fragment(w2, n2, nneg, nw, ntile, r0):
    """The lanes' B values for window n-tile ``ntile`` and k-step rows
    r0 .. r0 + 3: column g is window row ntile·4 + g // 2, re (g even) or
    im; b0 = its (row r0 + t, re) entry, b1 its (row, im) one."""
    qw = ntile * 4 + (GID >> 1)
    k2 = r0 + TIG
    live = (qw < nw) & (k2 < n2)
    q = np.where(qw < nneg, n2 - nneg + qw, qw - nneg)
    w = np.where(live, w2[np.clip(q, 0, n2 - 1), np.clip(k2, 0, n2 - 1)], 0)
    odd = (GID & 1) == 1
    b0 = np.where(odd, w.imag, w.real).astype(np.float32)
    b1 = np.where(odd, w.real, -w.imag).astype(np.float32)
    return b0, b1


def a_fragment(cre, cim, p_base, n1):
    """The lanes' A values of m-tile rows p_base .. p_base + 15 from a
    k-step's 4 C rows (``cre``/``cim`` [4, n1], swizzled; row t is chunk
    row 4k + t)."""
    o0, o1 = swz_wide(p_base + GID, TIG, n1), swz_wide(p_base + GID + 8, TIG, n1)
    return np.stack([cre[TIG, o0], cre[TIG, o1], cim[TIG, o0], cim[TIG, o1]], 1)


def fold(c_rows, w2, n2, nneg, npos, n1, three=True, ntiles=None):
    """The tensor-core fold of one pair's C rows ``[n2, n1]`` (re, im
    planes, swizzled): ``acc[ntile][warp][i] [32, 4]`` after all k-steps.
    ``three``: the 3xTF32 split, else one TF32 product."""
    mt = n1 // 16 // WARPS
    nw = nneg + npos
    ntiles = range(-(-nw // 4)) if ntiles is None else ntiles
    cre, cim = c_rows
    rows = -(-n2 // 4) * 4
    pad = lambda x: np.concatenate([x, np.zeros((rows - n2, x.shape[1]), np.float32)])
    cre, cim = pad(cre), pad(cim)
    acc = {}
    for nt in ntiles:
        for warp in range(WARPS):
            for i in range(mt):
                d = np.zeros((WARP, 4), np.float32)
                for r0 in range(0, rows, 4):
                    b0, b1 = b_fragment(w2, n2, nneg, nw, nt, r0)
                    a = a_fragment(cre[r0:r0 + 4], cim[r0:r0 + 4], (warp * mt + i) * 16, n1)
                    if three:
                        (ab, asm), (bb0, bs0), (bb1, bs1) = split(a), split(b0), split(b1)
                        d = mma(d, asm, np.stack([bb0, bb1], 1))
                        d = mma(d, ab, np.stack([bs0, bs1], 1))
                        d = mma(d, ab, np.stack([bb0, bb1], 1))
                    else:
                        d = mma(d, a, np.stack([b0, b1], 1))
                acc[nt, warp, i] = d
    return acc


def window_from_acc(acc, n1, nneg, npos, max_lag, inv_n):
    """The output pass: lane (g, t) of m-tile i holds z at window row
    ntile·4 + t, times p and p + 8; |z|/n into the window."""
    nw, mt = nneg + npos, n1 // 16 // WARPS
    out = np.full(2 * max_lag + 1, np.nan, np.float32)
    base = nneg * n1 - max_lag
    for (nt, warp, i), d in acc.items():
        qw = nt * 4 + TIG
        for h in range(2):
            p = (warp * mt + i) * 16 + GID + 8 * h
            f = qw * n1 + p - base
            ok = (qw < nw) & (f >= 0) & (f < out.size)
            x, y = d[:, 2 * h], d[:, 2 * h + 1]
            out[f[ok]] = (np.sqrt(x * x + y * y) * np.float32(inv_n))[ok]
    return out


def whitened(xr, xi, yr, yi, s2, eps, gate):
    """R = X·conj(Y) and the gate, in float32 (``rm_pair::whiten``)."""
    f32 = np.float32
    rr, ri = xr * yr + xi * yi, xi * yr - xr * yi
    if gate == "none":
        return rr, ri
    p2 = rr * rr + ri * ri
    if gate == "l1":
        mag = p2 * (f32(1) / np.sqrt(p2 + f32(1e-30)))
        inv = f32(1) / (mag + f32(eps) * mag.max(axis=-1, keepdims=True) + f32(1e-30))
    else:
        scale = p2.max(axis=-1) if gate == "l2" else s2
        inv = f32(1) / np.sqrt(p2 + f32(eps * eps) * scale[:, None] + f32(1e-30))
    return rr * inv, ri * inv


def lane_twiddles(n):
    """TW[k2][p] as a lane forms it for its times p0 + d: W_n^(k2·p0) and
    W_n^k2 from the two factor tables, then one product a time, in
    complex64: ``[n2, 32, P]`` in the order of ``inverse_times``."""
    n1, n2 = ct_plan.ct_split(n)
    t = gcc_pair.wide_twiddle_factors(n)
    t = (t[:, 0] + 1j * t[:, 1]).astype(np.complex64)
    nh, lo = -(-n // gcc_pair.WIDE_TW_LO), gcc_pair.WIDE_TW_LO
    look = lambda e: t[e // lo] * t[nh + e % lo]
    k2 = np.arange(n2)[:, None]
    p0 = (n1 // WARP) * np.array([int(format(l, "05b")[::-1], 2) for l in LANES])[None, :]
    w, step = look(k2 * p0), look(k2)  # [n2, 32], [n2, 1]
    out = np.empty((n2, WARP, n1 // WARP), np.complex64)
    for d in range(n1 // WARP):
        out[:, :, d] = w
        w = w * step
    return out


def c_rows(wr, wi_, n):
    """One pair's C rows as the FFT jobs store them: ``(re, im) [n2, n1]``
    with C[k2][p] = E[k2][p]·TW[k2][p] at ``swz_wide(p, k2)`` (chunks
    start at multiples of 4 rows, so a row's place in its chunk is k2 mod 4
    there)."""
    n1, n2 = ct_plan.ct_split(n)
    r = (wr + 1j * wi_).astype(np.complex64).reshape(n2, n1)
    v = warp_inverse_mixed(r.reshape(n2, n1 // WARP, WARP).swapaxes(-1, -2), n1)  # [n2, 32, P]
    times = inverse_times(n1)
    d_of = np.argsort(times, axis=1).argsort(axis=1)  # register i holds time p0 + d_of[l, i]
    tw = np.take_along_axis(lane_twiddles(n), np.broadcast_to(d_of, (n2, *d_of.shape)), axis=2)
    c = v * tw
    cre = np.zeros((n2, n1), np.float32)
    cim = np.zeros_like(cre)
    rows = np.arange(n2)[:, None, None]
    cre[rows, swz_wide(times[None], rows, n1)] = c.real
    cim[rows, swz_wide(times[None], rows, n1)] = c.imag
    return cre, cim


def w2_table(n):
    _, n2, _, _, w2re, w2im, _, _ = ct_plan.ct_constants(n, inverse=True)
    return (w2re + 1j * w2im).astype(np.complex64), n2


def wide_body(xr, xi, yr, yi, s2, max_lag, eps, gate, pairs):
    """``wide_pair_body`` for each pair ``[P, n]``, as the launch of
    :func:`gcc_pair.wide_plan` ``(.., pairs)`` splits its window."""
    n = xr.shape[-1]
    n1, _ = ct_plan.ct_split(n)
    nneg, npos = gcc_pair.window_rows(n, max_lag)
    w2, n2 = w2_table(n)
    plan = gcc_pair.wide_plan(n1, n2, nneg, npos, pairs)
    wr, wim = whitened(xr, xi, yr, yi, s2, eps, gate)
    out = []
    for k in range(xr.shape[0]):
        rows = c_rows(wr[k], wim[k], n)
        acc = {}
        for cg in range(plan.groups):  # blockIdx.y
            # slot j of a one-pair block: n-tile cg·ntg + j, below nt
            tiles = [cg * plan.ntg + j for j in range(plan.ntg) if cg * plan.ntg + j < -(-(nneg + npos) // 4)]
            acc.update(fold(rows, w2, n2, nneg, npos, n1, ntiles=tiles))
        out.append(window_from_acc(acc, n1, nneg, npos, max_lag, 1.0 / n))
    return np.stack(out)


@pytest.mark.parametrize("n1", WIDE)
def test_mma_fragment_map_covers_each_product_once(n1):
    """Over the warps, m-tiles, k-steps and lanes of one n-tile, every
    (time p, window column, chunk row, re|im) product of the fold is formed
    exactly once, and each lane's accumulator holds Re and Im of one
    window time."""
    mt = n1 // 16 // WARPS
    hits = np.zeros((n1, 8, 8), int)  # (p, B column, K index) per k-step
    for warp in range(WARPS):
        for i in range(mt):
            p_base = (warp * mt + i) * 16
            rows = [(GID, TIG), (GID + 8, TIG), (GID, TIG + 4), (GID + 8, TIG + 4)]  # a0..a3: (M row, K)
            for m, kk in rows:
                for n in range(8):  # every B column meets every A element of its K index
                    np.add.at(hits, (p_base + m, n, kk), 1)
    assert (hits == 1).all()
    b_cover = np.zeros((8, 8), int)  # (K, N) of b0, b1
    np.add.at(b_cover, (TIG, GID), 1)
    np.add.at(b_cover, (TIG + 4, GID), 1)
    assert (b_cover == 1).all()
    d_cover = np.zeros((16, 8), int)
    for m, n in ((GID, 2 * TIG), (GID, 2 * TIG + 1), (GID + 8, 2 * TIG), (GID + 8, 2 * TIG + 1)):
        np.add.at(d_cover, (m, n), 1)
    assert (d_cover == 1).all()
    # column 2t is Re and 2t + 1 Im of window row 4·ntile + t: one lane holds both
    qw_re, qw_im = (2 * TIG) >> 1, (2 * TIG + 1) >> 1
    np.testing.assert_array_equal(qw_re, qw_im)


@pytest.mark.parametrize("nfft", [58_368, 121_856])
def test_3xtf32_fold_is_within_1e_6_of_a_float64_fold(nfft):
    """The split keeps the fold at FP32 accuracy: within 1e-6 of the
    window's max |z| against float64 on the same C rows; one TF32
    product is ~1e-3 off."""
    n1, n2 = ct_plan.ct_split(nfft)
    nneg, npos = gcc_pair.window_rows(nfft, 600)
    rng = np.random.default_rng(nfft)
    c = (rng.normal(size=(n2, n1)) + 1j * rng.normal(size=(n2, n1))) * np.sqrt(n1)
    c[5] *= 30.0  # a strong row
    cre = np.zeros((n2, n1), np.float32)
    cim = np.zeros_like(cre)
    p = np.arange(n1)
    at = swz_wide(p[None], np.arange(n2)[:, None], n1)
    np.put_along_axis(cre, at, c.real.astype(np.float32), axis=1)
    np.put_along_axis(cim, at, c.imag.astype(np.float32), axis=1)
    w2, _ = w2_table(nfft)
    q = np.concatenate([np.arange(n2 - nneg, n2), np.arange(npos)])
    c32 = (np.take_along_axis(cre, at, 1) + 1j * np.take_along_axis(cim, at, 1)).astype(np.complex128)
    ref = w2[q].astype(np.complex128) @ c32  # [nw, n1]
    for three, limit in ((True, 1e-6), (False, None)):
        acc = fold((cre, cim), w2, n2, nneg, npos, n1, three=three)
        z = np.zeros_like(ref)
        mt = n1 // 16 // WARPS
        for (nt, warp, i), d in acc.items():
            qw = nt * 4 + TIG
            for h in range(2):
                pp = (warp * mt + i) * 16 + GID + 8 * h
                ok = qw < nneg + npos
                z[qw[ok], pp[ok]] = d[ok, 2 * h] + 1j * d[ok, 2 * h + 1]
        rel = np.abs(z - ref).max() / np.abs(ref).max()
        if three:
            assert rel <= limit, rel
        else:
            assert rel > 1e-5, rel  # one TF32 product would not hold the kernels' tolerance


CASES = [(58_368, 600), (87_040, 600), (121_856, 600), (58_368, 2048)]


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("nfft,max_lag", CASES)
def test_wide_body_replica_matches_plain(nfft, max_lag, gate):
    b, eps = 3, 0.05
    sre, sim, smax = correlated_spectra(1, b, nfft, nfft % 89)
    sre, sim, smax = sre[0], sim[0], smax[0]
    pi, pj = np.array([0, 1]), np.array([1, 2])
    x = [np.ascontiguousarray(a[idx]) for idx in (pi, pj) for a in (sre, sim)]
    s2 = pair_gate_scales(smax, pi, pj) if gate == "l2rx" else None
    ours = wide_body(*x, s2, max_lag, eps, gate, pairs=2)
    ref = gcc_pair._whiten_invert_plain(
        *(torch.from_numpy(a) for a in x), None if s2 is None else torch.from_numpy(s2), max_lag, eps, gate
    ).numpy()
    assert ours.shape == ref.shape == (len(pi), 2 * max_lag + 1) and np.isfinite(ours).all()
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


def _bank_load(words):
    return max(np.bincount(np.asarray(words) % BANKS, minlength=BANKS))


@pytest.mark.parametrize("n1", WIDE)
def test_wide_stores_and_fold_reads_are_free_of_bank_conflicts(n1):
    """A warp's store of time P·brev5(l) + d of row rr (one float a lane,
    each plane) hits 32 banks for every d and rr; the fold's A reads
    (rows 4k + t, times p_base + g and + 8) too; so do the FFT jobs' reads
    of bins l + 32·i; the swizzle is a permutation of each row, and the
    kernel's two shortcuts for it agree with it."""
    p = n1 // WARP
    b = np.array([int(format(l, "05b")[::-1], 2) for l in LANES])
    p0, kb = p * b, b >> 3  # a lane's first time; its times are p0 .. p0 + P - 1 (inverse_times)
    np.testing.assert_array_equal(np.sort(inverse_times(n1), axis=1), p0[:, None] + np.arange(p))
    for rr in range(8):
        for d in range(p):
            o = swz_wide(p0 + d, rr, n1)
            assert _bank_load(rr * n1 + o) == 1
            np.testing.assert_array_equal(o, (p0 + (d ^ kb)) ^ ((rr & 3) << 3))
        assert sorted(swz_wide(np.arange(n1), rr, n1)) == list(range(n1))
    for p_base in range(0, n1, 16):
        lo = GID ^ ((p_base // (8 * p)) & 3)
        for h in (0, 8):
            o = swz_wide(p_base + GID + h, TIG, n1)
            assert _bank_load(TIG * n1 + o) == 1
            np.testing.assert_array_equal(o, ((p_base + h) ^ (TIG << 3)) + lo)
    for i in range(p):
        assert _bank_load(3 * n1 + LANES + 32 * i) == 1
    assert (4 * n1 * 4) % 16 == 0  # a chunk's plane lands 16-byte aligned


PLANNED_WIDE = [n for n in sorted({ct_plan.plan_nfft(m) for m in range(1024, 131_073, 1024)})
                if ct_plan.ct_split(n)[0] in WIDE]


def test_double_buffer_fits_shared_memory_and_two_blocks_at_384():
    """The widest planned window (129024 = 384·336, max_lag 2048) and every
    planned wide length at max_lag 600 and 2048 fit one block's shared
    memory; at n1 = 384 two blocks of K2 and of K5/K6 fit an SM at the
    flagship's 58368 = 384·152, max_lag 600."""
    n1, n2, nneg, npos = gcc_pair._geometry(129_024, 2048, "K5")
    assert (n1, n2) == (384, 336)
    for pairs in (1, 2):
        plan = gcc_pair.wide_plan(n1, n2, nneg, npos, pairs)
        assert plan.smem == gcc_pair.wide_smem_bytes(n1, n2, plan.nsrc, plan.rows, plan.ntg)
        assert plan.smem + gcc_pair.WIDE_STATIC_SMEM <= gcc_pair.SMEM_LIMIT
    assert len(PLANNED_WIDE) == 23
    for n in PLANNED_WIDE:
        n1, n2 = ct_plan.ct_split(n)
        for lag in (600, 2048):
            nneg, npos = gcc_pair.window_rows(n, lag)
            for pairs in (1, 2):
                plan = gcc_pair.wide_plan(n1, n2, nneg, npos, pairs)
                assert plan.smem + gcc_pair.WIDE_STATIC_SMEM <= gcc_pair.SMEM_LIMIT
                assert plan.pairs * plan.ntg <= gcc_pair.WIDE_SLOTS and plan.rows % 4 == 0
                assert plan.groups * plan.ntg >= -(-(nneg + npos) // 4)
    k2 = gcc_pair.wide_plan(384, 152, 2, 2, 2)
    assert (k2.pairs, k2.nsrc, k2.rows, k2.ntg, k2.groups) == (2, 3, 4, 1, 1)
    k5 = gcc_pair.wide_plan(384, 152, 2, 2, 1)
    assert (k5.pairs, k5.nsrc, k5.rows) == (1, 2, 8)
    for plan in (k2, k5):
        assert 2 * (plan.smem + gcc_pair.WIDE_STATIC_SMEM + SM_RESERVED) <= SM_SHARED


@pytest.mark.parametrize("b", [2, 3, 8, 16, 64])
def test_wide_tiles_cover_every_pair_exactly_once(b):
    """K2's tiles: each pair of the list in exactly one tile, with its X
    and Y receivers where the kernel reads them (slot 0 or the leaf); all
    28 pairs of 8 receivers in 14 tiles of two."""
    lists = [gcc_phat.pair_indices(b)]
    rng = np.random.default_rng(b)
    i = rng.integers(0, b, size=3 * b)
    lists.append((i, (i + rng.integers(0, b, size=i.size)) % b))  # repeats and self-pairs too
    for pi, pj in lists:
        tiles = gcc_pair.wide_tiles(pi, pj, 2)
        seen = []
        for t in tiles:
            assert t[3] in (1, 2)
            for g in range(t[3]):
                k, leaf_x = t[4 + 2 * g], t[5 + 2 * g]
                xs, ys = (g + 1, 0) if leaf_x else (0, g + 1)
                assert (t[xs], t[ys]) == (pi[k], pj[k])
                seen.append(k)
        assert sorted(seen) == list(range(len(pi)))
    tiles = gcc_pair.wide_tiles(*gcc_phat.pair_indices(8), 2)
    if b == 8:
        assert tiles.shape == (14, 8) and (tiles[:, 3] == 2).all()
    one = gcc_pair.wide_tiles(*lists[0], 1)
    assert (one[:, 3] == 1).all() and len(one) == len(lists[0][0])
