"""The GCC pair body of kernels K2, K5, K6 and K8's pair half, at every
inner length n1 = 128, 256, 384, 640, 896, replayed in numpy on the CPU.

``csrc/gcc_pair_wide.cuh`` (``wide_pair_body``) stages a tile's sources a
chunk of CT rows at a time in shared memory (one bulk copy a source
plane), runs the warp FFT (radix-2 at n1 = 128, 256, replayed in
``tests/test_torch_pair_fft.py``; mixed radix above, in
``tests/test_torch_mixed_radix.py``) one (pair, row) job a warp, stores
C = E·TW over the pair's leaf row at ``swz_wide(p, row)`` (XORs of p's low
bits) and folds the window rows on tensor cores: per k-step of 4 rows,
``mma.sync.m16n8k8`` TF32 with A[p][(row, re|im)] = C and
B[(row, re|im)][(window row, re|im)] from W2, in the 3xTF32 split
(small·big + big·small + big·big on the tensor cores from zero, each
k-step's sum then added to the accumulator in FP32). A block holds
``gcc_pair.WIDE_SLOTS[n1]`` accumulator slots; warp w of a 256-thread
block owns m-tiles w·n1/128 .. (w + 1)·n1/128 − 1 of each, and a
512-thread block (kernel K8) splits the slots between its two halves.

Held here: the fragment map covers every (p, window row, k2) product
exactly once, and the warps of 256 and 512 threads every (slot, m-tile)
once; the 3xTF32 fold stays within 1e-6 of a float64 fold (one TF32
product does not); the replica of the whole body equals the plain version
the kernels are held to (1e-5 of the window max, same argmax) at every
gate, with tiles of two pairs and with the window split over blocks, and
the JAX Pallas kernel in interpret mode at n1 = 128; the stores and the
fold's reads are free of bank conflicts; the double buffer fits shared
memory at the widest planned window (129024 = 384·336, max_lag 2048),
n1 = 128, 256 and 384 keep two blocks an SM, and kernel K8's pair buffers
fit its row; K2's tiles cover every pair exactly once.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch.ops import ct_plan, gcc_phat
from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import correlated_spectra, pair_gate_scales
from test_torch_mixed_radix import inverse_times
from test_torch_pair_fft import warp_inverse_fft

cap_cpu_threads()

WARP, WARPS, BANKS = 32, 8, 32
LANES = np.arange(WARP)
GID, TIG = LANES >> 2, LANES & 3  # mma fragment coordinates
N1S = (128, 256, 384, 640, 896)
GATES = ("l2rx", "l2", "l1", "none")
SM_SHARED = 233_472  # the H100's shared memory an SM (228 KB)
SM_RESERVED = 1024  # the runtime's share a resident block
STATIC_SMEM = 512  # the kernels' static shared memory (the tile, barriers): 312 B, from the card's attributes


def swz_lo(p, n1):
    """``rm_wide::swz_lo<P>``: the low bits of time p that the swizzle
    XORs, (p / 8P) mod 4, or (p / 32) mod 8 at P = 8."""
    p, pts = np.asarray(p), n1 // WARP
    return (p >> 5) & 7 if pts == 8 else (p // (8 * pts)) & 3


def swz_wide(p, rr, n1):
    """``rm_wide::swz_wide<P>``: where time p of C row rr sits in its row."""
    p = np.asarray(p)
    return (p ^ swz_lo(p, n1)) ^ ((np.asarray(rr) & 3) << 3)


def layout(n1, threads, npairs, ntl):
    """``rm_wide::Layout`` and the body's warp assignment for a tile of
    ``npairs`` pairs with ``ntl`` n-tiles each in the block: ``{w:
    (m-tiles, [(pair, n-tile)], slots)}``, slots a warp's accumulators."""
    warps, mtiles, slots = threads // WARP, n1 // 16, gcc_pair.WIDE_SLOTS[n1]
    sg = warps // mtiles if warps > mtiles else 1
    mt, sw = mtiles * sg // warps, slots // sg
    out = {}
    for w in range(warps):
        m = range((w % (warps // sg)) * mt, (w % (warps // sg)) * mt + mt)
        if sg == 1:
            combos = [(g, u) for g in range(npairs) for u in range(ntl)]
        else:  # K8's halves: a pair each, or a half each of one pair's n-tiles
            h, a = w // (warps // 2), (ntl + 1) // 2
            half = range(a, ntl) if h else range(a)
            combos = [(h, u) for u in range(ntl)] if npairs == 2 else [(0, u) for u in half]
        out[w] = (m, combos, sw)
    return out


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


def fold(c_rows, w2, n2, nneg, npos, n1, three=True, ntiles=None, chunk=4):
    """The tensor-core fold of one pair's C rows ``[n2, n1]`` (re, im
    planes, swizzled) as a kernel with ``chunk`` rows a chunk runs it:
    ``acc[ntile, m-tile] [32, 4]`` after all k-steps (chunk by chunk, the
    k-steps of 4 rows that reach a live row). ``three``: the 3xTF32 split,
    else one TF32 product. Returns the accumulators and the k-steps' first
    rows in the order they were added."""
    assert chunk % 4 == 0
    nw = nneg + npos
    ntiles = range(-(-nw // 4)) if ntiles is None else ntiles
    cre, cim = c_rows
    rows = -(-n2 // 4) * 4
    pad = lambda x: np.concatenate([x, np.zeros((rows - n2, x.shape[1]), np.float32)])
    cre, cim = pad(cre), pad(cim)
    steps = [r0 + 4 * ks for r0 in range(0, n2, chunk) for ks in range(-(-min(chunk, n2 - r0) // 4))]
    acc = {}
    for nt in ntiles:
        for m in range(n1 // 16):
            d = np.zeros((WARP, 4), np.float32)
            for r0 in steps:
                b0, b1 = b_fragment(w2, n2, nneg, nw, nt, r0)
                a = a_fragment(cre[r0:r0 + 4], cim[r0:r0 + 4], m * 16, n1)
                if three:  # the k-step's sum on the tensor cores, added to the accumulator in FP32
                    (ab, asm), (bb0, bs0), (bb1, bs1) = split(a), split(b0), split(b1)
                    t = mma(np.zeros_like(d), asm, np.stack([bb0, bb1], 1))
                    t = mma(t, ab, np.stack([bs0, bs1], 1))
                    d = d + mma(t, ab, np.stack([bb0, bb1], 1))
                else:
                    d = mma(d, a, np.stack([b0, b1], 1))
            acc[nt, m] = d
    return acc, steps


def window_from_acc(acc, n1, nneg, npos, max_lag, inv_n):
    """The output pass: lane (g, t) of m-tile m holds z at window row
    ntile·4 + t, times p and p + 8; |z|/n into the window."""
    nw = nneg + npos
    out = np.full(2 * max_lag + 1, np.nan, np.float32)
    base = nneg * n1 - max_lag
    for (nt, m), d in acc.items():
        qw = nt * 4 + TIG
        for h in range(2):
            p = m * 16 + GID + 8 * h
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
    v = warp_inverse_fft(r.reshape(n2, n1 // WARP, WARP).swapaxes(-1, -2), n1)  # [n2, 32, P]
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


def wide_body(xr, xi, yr, yi, s2, max_lag, eps, gate, pairs, plan=None):
    """``wide_pair_body`` for each pair ``[P, n]``, as a launch of ``plan``
    (default :func:`gcc_pair.wide_plan` ``(.., pairs)``) splits its window
    and chunks its rows."""
    n = xr.shape[-1]
    n1, _ = ct_plan.ct_split(n)
    nneg, npos = gcc_pair.window_rows(n, max_lag)
    w2, n2 = w2_table(n)
    plan = plan or gcc_pair.wide_plan(n1, n2, nneg, npos, pairs)
    nt = -(-(nneg + npos) // 4)
    wr, wim = whitened(xr, xi, yr, yi, s2, eps, gate)
    out = []
    for k in range(xr.shape[0]):
        rows = c_rows(wr[k], wim[k], n)
        acc = {}
        for cg in range(plan.groups):  # blockIdx.y (kernel K8: a loop)
            tiles = [cg * plan.ntg + j for j in range(plan.ntg) if cg * plan.ntg + j < nt]
            acc.update(fold(rows, w2, n2, nneg, npos, n1, ntiles=tiles, chunk=plan.rows)[0])
        out.append(window_from_acc(acc, n1, nneg, npos, max_lag, 1.0 / n))
    return np.stack(out)


@pytest.mark.parametrize("n1", N1S)
def test_mma_fragment_map_covers_each_product_once(n1):
    """Over the warps, m-tiles, k-steps and lanes of one n-tile, every
    (time p, window column, chunk row, re|im) product of the fold is formed
    exactly once, and each lane's accumulator holds Re and Im of one
    window time."""
    hits = np.zeros((n1, 8, 8), int)  # (p, B column, K index) per k-step
    for warp, (mtiles, _, _) in layout(n1, gcc_pair.THREADS, 1, 1).items():
        for m in mtiles:
            p_base = m * 16
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


@pytest.mark.parametrize("nfft,max_lag", [(58_368, 600), (121_856, 600), (17_408, 512), (34_816, 512)])
def test_3xtf32_fold_is_within_1e_6_of_a_float64_fold(nfft, max_lag):
    """The split keeps the fold at FP32 accuracy: within 1e-6 of the
    window's max |z| against float64 on the same C rows (so τ, the
    windows' tolerance against the plain FP32 version, is unchanged,
    also at n1 = 128 and 256 with their 9 and 5 window rows); one TF32
    product is ~1e-3 off."""
    n1, n2 = ct_plan.ct_split(nfft)
    nneg, npos = gcc_pair.window_rows(nfft, max_lag)
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
        acc, _ = fold((cre, cim), w2, n2, nneg, npos, n1, three=three)
        z = np.zeros_like(ref)
        for (nt, m), d in acc.items():
            qw = nt * 4 + TIG
            for h in range(2):
                pp = m * 16 + GID + 8 * h
                ok = qw < nneg + npos
                z[qw[ok], pp[ok]] = d[ok, 2 * h] + 1j * d[ok, 2 * h + 1]
        rel = np.abs(z - ref).max() / np.abs(ref).max()
        if three:
            assert rel <= limit, rel
        else:
            assert rel > 1e-5, rel  # one TF32 product would not hold the kernels' tolerance


# the mixed lengths, the window over two blocks at 58368, and n1 = 128
# (the wideband 5120 and the flagship 17408) and 256 (34816)
CASES = [(58_368, 600), (87_040, 600), (121_856, 600), (58_368, 2048), (5120, 128), (17_408, 512), (34_816, 512)]


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


@pytest.mark.parametrize("n1", N1S)
def test_wide_stores_and_fold_reads_are_free_of_bank_conflicts(n1):
    """A warp's store of time P·brev5(l) + d of row rr (one float a lane,
    each plane) hits 32 banks for every d and rr; the fold's A reads
    (rows 4k + t, times p_base + g and + 8) too; so do the FFT jobs' reads
    of bins l + 32·i; the swizzle is a permutation of each row, and the
    kernel's two shortcuts for it agree with it. At P = 8 the swizzle
    takes three low bits: with (p / 8P) mod 4, as at the other P, half
    the stores would meet a second lane on their bank."""
    p = n1 // WARP
    b = np.array([int(format(l, "05b")[::-1], 2) for l in LANES])
    p0 = p * b  # a lane's first time; its times are p0 .. p0 + P - 1 (inverse_times)
    kb = swz_lo(p0, n1)
    np.testing.assert_array_equal(kb, (b >> 2) & 7 if p == 8 else b >> 3)
    np.testing.assert_array_equal(np.sort(inverse_times(n1), axis=1), p0[:, None] + np.arange(p))
    for rr in range(8):
        for d in range(p):
            o = swz_wide(p0 + d, rr, n1)
            assert _bank_load(rr * n1 + o) == 1
            np.testing.assert_array_equal(o, (p0 + (d ^ kb)) ^ ((rr & 3) << 3))
            if p == 8:  # what the third bit removes
                two = (p0 + d) ^ (((p0 + d) // (8 * p)) & 3) ^ ((rr & 3) << 3)
                assert _bank_load(rr * n1 + two) == 2
        assert sorted(swz_wide(np.arange(n1), rr, n1)) == list(range(n1))
    for p_base in range(0, n1, 16):
        lo = GID ^ swz_lo(p_base, n1)
        for h in (0, 8):
            o = swz_wide(p_base + GID + h, TIG, n1)
            assert _bank_load(TIG * n1 + o) == 1
            np.testing.assert_array_equal(o, ((p_base + h) ^ (TIG << 3)) + lo)
    for i in range(p):
        assert _bank_load(3 * n1 + LANES + 32 * i) == 1
    assert (4 * n1 * 4) % 16 == 0  # a chunk's plane lands 16-byte aligned


@pytest.mark.parametrize("n1,threads", [(128, 256), (256, 256), (384, 256), (640, 256), (896, 256), (128, 512)])
def test_warps_own_each_slot_and_m_tile_once(n1, threads):
    """``rm_wide::Layout``: for every tile a plan can give a block (pairs ×
    n-tiles within its slots; K8's 512 threads take at most two pairs),
    the block's warps hold every (pair, n-tile, m-tile) accumulator once,
    within their slots; 256 threads give each warp n1/128 m-tiles of
    every (pair, n-tile), K8's two halves of 8 warps a pair each or half a
    pair's n-tiles each, so each accumulator runs the same mma sequence
    at either block size."""
    slots = gcc_pair.WIDE_SLOTS[n1]
    tiles = [(p, u) for p in range(1, (2 if threads == 512 else gcc_pair.TILE_PAIRS) + 1)
             for u in range(1, slots + 1) if p * u <= slots]
    for npairs, ntl in tiles:
        own = layout(n1, threads, npairs, ntl)
        held = sorted((g, u, m) for mtiles, combos, _ in own.values() for g, u in combos for m in mtiles)
        assert held == [(g, u, m) for g in range(npairs) for u in range(ntl) for m in range(n1 // 16)]
        assert all(len(combos) <= sw for _, combos, sw in own.values())
    # accumulator floats a thread: 24 at n1 = 128 and 384, 32 at 256, 12 in K8
    regs = {len(m) * sw * 4 for m, _, sw in layout(n1, threads, 1, 1).values()}
    assert regs == {{128: 24, 256: 32, 384: 24, 640: 40, 896: 56}[n1] * 256 // threads}


PLANNED = sorted({ct_plan.plan_nfft(m) for m in range(1024, 131_073, 1024)})
PLANNED_WIDE = [n for n in PLANNED if ct_plan.ct_split(n)[0] in N1S[2:]]


def test_double_buffer_fits_shared_memory_and_two_blocks_at_384():
    """The widest planned window (129024 = 384·336, max_lag 2048) and every
    planned length at max_lag 600 and 2048 fit one block's shared
    memory; at n1 = 384 two blocks of K2 and of K5/K6 fit an SM at the
    flagship's 58368 = 384·152, max_lag 600."""
    n1, n2, nneg, npos = gcc_pair._geometry(129_024, 2048, "K5")
    assert (n1, n2) == (384, 336)
    for pairs in (1, 2):
        plan = gcc_pair.wide_plan(n1, n2, nneg, npos, pairs)
        assert plan.smem == gcc_pair.wide_smem_bytes(n1, n2, plan.nsrc, plan.rows, plan.ntg)
        assert plan.smem + gcc_pair.WIDE_STATIC_SMEM <= gcc_pair.SMEM_LIMIT
    assert len(PLANNED_WIDE) == 23
    for n in PLANNED:
        n1, n2 = ct_plan.ct_split(n)
        for lag in (600, 2048):
            nneg, npos = gcc_pair.window_rows(n, lag)
            if lag >= n // 2:
                continue
            for pairs in (1, 2):
                plan = gcc_pair.wide_plan(n1, n2, nneg, npos, pairs)
                assert plan.smem + gcc_pair.WIDE_STATIC_SMEM <= gcc_pair.SMEM_LIMIT
                assert plan.pairs * plan.ntg <= gcc_pair.WIDE_SLOTS[n1] and plan.rows % 4 == 0
                assert plan.groups * plan.ntg >= -(-(nneg + npos) // 4)
    k2 = gcc_pair.wide_plan(384, 152, 2, 2, 2)
    assert (k2.pairs, k2.nsrc, k2.rows, k2.ntg, k2.groups) == (2, 3, 4, 1, 1)
    k5 = gcc_pair.wide_plan(384, 152, 2, 2, 1)
    assert (k5.pairs, k5.nsrc, k5.rows) == (1, 2, 8)
    for plan in (k2, k5):
        assert 2 * (plan.smem + gcc_pair.WIDE_STATIC_SMEM + SM_RESERVED) <= SM_SHARED


@pytest.mark.parametrize("nfft,max_lag,pairs,want,blocks", [
    (17_408, 512, 2, (2, 3, 8, 3, 1), 3),   # K2, the flagship: 2 pairs × 3 n-tiles of its 9 window rows
    (5120, 128, 6, (6, 7, 4, 1, 1), 3),     # K5's tiles of six at the wideband block: one n-tile each
    (5120, 128, 1, (1, 2, 16, 1, 1), 3),    # K6 at the wideband block
    (34_816, 512, 2, (2, 3, 8, 2, 1), 2),   # K2 at n1 = 256: 2 pairs × 2 n-tiles of 5 rows
    (17_408, 2048, 2, (1, 2, 16, 6, 2), 2),  # a window past 6 n-tiles: one pair, two blocks along it
])
def test_narrow_plans_keep_blocks_an_sm(nfft, max_lag, pairs, want, blocks):
    """At n1 = 128 and 256 a chunk carries 16 or 8 CT rows for one pair, 8
    for K2's two (three blocks an SM at 128), 4 for K5's six; the tile's
    n-tiles fit the block's 6 or 4 slots; the blocks fit an SM's shared
    memory (the registers allow three at 128, two at 256)."""
    n1, n2, nneg, npos = gcc_pair._geometry(nfft, max_lag, "K2")
    plan = gcc_pair.wide_plan(n1, n2, nneg, npos, pairs)
    assert (plan.pairs, plan.nsrc, plan.rows, plan.ntg, plan.groups) == want
    assert plan.pairs * plan.ntg <= gcc_pair.WIDE_SLOTS[n1]
    assert blocks * (plan.smem + STATIC_SMEM + SM_RESERVED) <= SM_SHARED
    assert -(-n2 // plan.rows) <= 34  # barrier rounds a tile


@pytest.mark.parametrize("nfft,max_lag", [(17_408, 512), (9216, 512), (5120, 256), (5120, 128), (17_408, 2048),
                                          (24_576, 512)])
def test_k8_pair_buffers_fit_its_row_and_fold_in_k2_order(nfft, max_lag):
    """Kernel K8's pair half runs K2's body in its row's shared memory
    (n complex floats): :func:`channel_step.pair_plan` fits it there, with
    K2's tiles of two where they fit; its chunks and K2's add the same
    k-steps in the same order, so the windows equal K2's bit for bit."""
    from radio_mapper_tpu_torch.ops.cuda import channel_step

    n1, n2, nneg, npos = gcc_pair._geometry(nfft, max_lag, "K8")
    k8 = channel_step.pair_plan(nfft, nneg, npos)
    k2 = gcc_pair.wide_plan(n1, n2, nneg, npos, 2)
    assert k8.smem <= nfft * 8 and k8.rows % 4 == 0
    assert k8.pairs == (2 if max_lag <= 600 else 1)
    c = (np.zeros((n2, n1), np.float32),) * 2
    w2, _ = w2_table(nfft)
    steps = lambda plan: fold(c, w2, n2, nneg, npos, n1, ntiles=[], chunk=plan.rows)[1]
    assert steps(k8) == steps(k2) == list(range(0, n2, 4))


def test_replica_matches_jax_pallas_interpret_at_n1_128():
    """The body's replica and the reference's Pallas kernel
    (``gcc_kernel.gcc_pair_lag_mags``, interpret mode, the main path's
    l2rx gate on the per-receiver maxima) on the same numpy spectra at
    nfft 5120 = 128·40: within 1e-4 of each window's max, same argmax."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from radio_mapper_tpu.ops.pallas import gcc_kernel

    c, b, nfft, max_lag = 2, 4, 5120, 128
    sre, sim, smax = correlated_spectra(c, b, nfft, 0)
    pi, pj = gcc_phat.pair_indices(b)
    ref = np.asarray(gcc_kernel.gcc_pair_lag_mags(sre, sim, pi, pj, max_lag=max_lag, eps=0.05, row_smax=smax,
                                                  interpret=True))
    ours = np.stack([wide_body(sre[k, pi], sim[k, pi], sre[k, pj], sim[k, pj],
                               pair_gate_scales(smax[k], pi, pj), max_lag, 0.05, "l2rx", pairs=2)
                     for k in range(c)])
    assert ours.shape == ref.shape == (c, len(pi), 2 * max_lag + 1)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-4 * scale).all()
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("b", [2, 3, 8, 16, 64])
def test_wide_tiles_cover_every_pair_exactly_once(b):
    """The tile kernel's tiles: each pair of the list in exactly one tile,
    with its X and Y receivers where the kernel reads them (slot 0 or its
    leaf, slot g + 1); all 28 pairs of 8 receivers in 14 tiles of two; in
    tiles of up to six, a tile of two or more shares its centre."""
    lists = [gcc_phat.pair_indices(b)]
    rng = np.random.default_rng(b)
    i = rng.integers(0, b, size=3 * b)
    lists.append((i, (i + rng.integers(0, b, size=i.size)) % b))  # repeats and self-pairs too
    ns = gcc_pair.TILE_PAIRS + 1  # the pair count's place: after the slots' receivers
    for pairs in (2, gcc_pair.TILE_PAIRS):
        for pi, pj in lists:
            tiles = gcc_pair.wide_tiles(pi, pj, pairs)
            assert tiles.shape[1] == gcc_pair.TILE_INTS
            seen = []
            for t in tiles:
                assert 1 <= t[ns] <= pairs and (t[t[ns] + 1:ns] == -1).all()
                for g in range(t[ns]):
                    k, leaf_x = t[ns + 1 + 2 * g], t[ns + 2 + 2 * g]
                    xs, ys = (g + 1, 0) if leaf_x else (0, g + 1)
                    assert (t[xs], t[ys]) == (pi[k], pj[k])
                    seen.append(k)
            assert sorted(seen) == list(range(len(pi)))
    tiles = gcc_pair.wide_tiles(*gcc_phat.pair_indices(8), 2)
    if b == 8:
        assert tiles.shape == (14, gcc_pair.TILE_INTS) and (tiles[:, ns] == 2).all()
    if b == 64:  # K5's tiles of the wideband block's 2016 pairs: 354 blocks, not 2016
        six = gcc_pair.wide_tiles(*lists[0], gcc_pair.TILE_PAIRS)
        assert len(six) == 354 and (six[:, ns] == 6).sum() == 311
    one = gcc_pair.wide_tiles(*lists[0], 1)
    assert (one[:, ns] == 1).all() and len(one) == len(lists[0][0])
