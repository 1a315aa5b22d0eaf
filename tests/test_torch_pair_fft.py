"""The GCC pair body of kernels K2, K5, K6 and K8, replayed in numpy on the CPU.

``csrc/gcc_pair.cuh`` (``pair_lag_window``, n1 = 128 and 256; the wide
lengths' body, ``csrc/gcc_pair_wide.cuh``, is replayed in
``tests/test_torch_pair_wide.py``) turns a pair's CT-order spectra X, Y
(bin k = k2 + n2·k1 at m = k2·n1 + k1) into its lag window:

- one warp per CT row k2, point i of lane l holding bin k1 = l + 32·i
  (i < P = n1/32): R = X·conj(Y), whitened by the gate, in registers;
- the inner inverse n1-point FFT, radix-2 DIF with conjugate twiddles
  W_n1^−e, e = (t mod h)·(n1/2)/h for the pair (t, t + h): the stages of
  half-size h = n1/2 .. 32 pair points i and i + h/32 of a lane in
  registers, the stages h = 16 .. 1 pair lane l with lane l ^ h (the lane
  whose bit h is clear keeps a + b, its partner (a − b)·W); each lane's
  exponents depend on the lane and i, never on the row; point i of lane l
  then holds E[brev(l + 32·i)] = E[P·brev5(l) + brev(i)];
- that times the inverse twiddle W_n^(k2·p), stored in 16-byte words at
  the swizzled place ``swz(p)`` of the chunk buffer, and each chunk of
  ``gcc_pair.chunk_rows(THREADS, n1)`` rows folded into the window rows
  z[q] += W_n2^(−q·k2)·C[k2], k2 ascending;
- |z|/n over lags −L..L.

The replica runs exactly that in float32/complex64 and must equal
``np.fft.ifft``·n1 and the direct DFT of the ``w1`` table row by row, and
the whole body must equal ``gcc_pair._whiten_invert_plain`` (the plain
version the kernels are held to) within 1e-5 of each window's max, for
the four gates, at nfft 5120 (L 128) and 17408 (L 512), n1 = 128,
34816 (L 512), n1 = 256, and — the same chunked fold around the
mixed-radix warp FFT of ``tests/test_torch_mixed_radix.py`` — at 52224,
87040 and 121856 (L 600), n1 = 384, 640 and 896. Blocks of 256 (K2, K5,
K6) and 512 threads (K8)
chunk the rows differently and must give identical windows. The chunk
buffer's stores and the fold's reads are held free of bank conflicts, and
the text edits of ``tools/pair_parts.py`` to the current sources. No JAX
here.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import channel_step, gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import correlated_spectra, pair_gate_scales
from test_torch_mixed_radix import digit, warp_inverse_mixed

cap_cpu_threads()

WARP, BANKS = 32, 32
LANES = np.arange(WARP)
GATES = ("l2rx", "l2", "l1", "none")
# (nfft, max_lag): the wideband and flagship lengths (n1 = 128),
# 34816 = 256·136, a length the kernels serve with n1 = 256, and the
# mixed-radix inner lengths 384·136, 640·136 and 896·136
CASES = [(5120, 128), (17408, 512), (34816, 512), (52224, 600), (87040, 600), (121856, 600)]


def _brev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _c64(pairs: np.ndarray) -> np.ndarray:
    return (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)


def positions(n1: int) -> np.ndarray:
    """``[32, P]``: the time p point i of lane l holds after the FFT,
    P·brev5(l) + digit(i) (for P = 4, 8: brev(l + 32·i) over log2(n1) bits)."""
    p = n1 // WARP
    return np.array([[p * _brev(lane, 5) + digit(p, i) for i in range(p)] for lane in LANES])


def swz(p, pts: int):
    """``rm_pair::swz<P>``: where time p of a row sits in the chunk buffer."""
    return p ^ (((p // (4 * pts)) & 7) << 1)


def register_stages(n1: int):
    """The stages in registers: ``(h, g, pairs)`` with g = h/32 and, for
    each point i < i + g of a pair, ``(i, j, e [32])``: the kernel's table
    slot ``P − h/16 + j`` (j = i mod g) and its exponent per lane."""
    p = n1 // WARP
    h = n1 // 2
    while h >= WARP:
        g = h // WARP
        pairs = [(i, i & (g - 1), (LANES + WARP * (i & (g - 1))) * (n1 // 2 // h))
                 for i in range(p) if not i & g]
        yield h, g, pairs
        h //= 2


def lane_stages(n1: int):
    """The shuffle stages: ``(h, partner [32], top [32], e [32])``."""
    for s in range(5):
        h = 16 >> s
        yield h, LANES ^ h, (LANES & h) == 0, (LANES & (h - 1)) * (n1 // 2 // h)


def warp_inverse_fft(v: np.ndarray, n1: int) -> np.ndarray:
    """``inverse_row_fft<n1>`` on rows held as ``v [..., 32, P]`` complex64
    (lane l, point i = bin l + 32·i); returns the registers after the FFT."""
    if n1 not in (128, 256):
        return warp_inverse_mixed(v, n1)
    wi = _c64(ct_plan.inverse_radix_table(n1))
    v = v.copy()
    for _, g, pairs in register_stages(n1):
        for i, _, e in pairs:
            a, b = v[..., i].copy(), v[..., i + g].copy()
            v[..., i] = a + b
            v[..., i + g] = (a - b) * wi[e]
    for _, partner, top, e in lane_stages(n1):
        w = v[..., partner, :]  # __shfl_xor_sync
        v = np.where(top[:, None], v + w, (w - v) * wi[e][:, None])
    return v


def row_transform(r: np.ndarray) -> np.ndarray:
    """Rows ``r [..., n1]`` (natural k1) → E ``[..., n1]`` in natural p,
    through the warp schedule."""
    n1 = r.shape[-1]
    v = warp_inverse_fft(r.reshape(*r.shape[:-1], n1 // WARP, WARP).swapaxes(-1, -2), n1)
    e = np.empty_like(r)
    e[..., positions(n1)] = v
    return e


def pair_body(xr, xi, yr, yi, s2, max_lag, eps, gate, threads):
    """``pair_lag_window<threads>`` on float32 pair spectra ``[pairs, n]``
    (CT order); ``s2 [pairs]`` is the l2rx gate scale."""
    pairs, n = xr.shape
    n1, n2 = ct_plan.ct_split(n)
    nneg, npos = gcc_pair.window_rows(n, max_lag)
    f32 = np.float32
    rr = xr * yr + xi * yi  # R = X·conj(Y)
    ri = xi * yr - xr * yi
    if gate == "none":
        wr, wim = rr, ri
    else:
        p2 = rr * rr + ri * ri
        if gate == "l1":
            mag = p2 * (f32(1) / np.sqrt(p2 + f32(1e-30)))
            l1_floor = f32(eps) * mag.max(axis=-1, keepdims=True)
            inv = f32(1) / (mag + l1_floor + f32(1e-30))
        else:
            scale = p2.max(axis=-1) if gate == "l2" else s2
            floor2 = f32(eps * eps) * scale[:, None]
            inv = f32(1) / np.sqrt(p2 + floor2 + f32(1e-30))
        wr, wim = rr * inv, ri * inv
    r = (wr + 1j * wim).astype(np.complex64).reshape(pairs, n2, n1)

    _, _, _, _, w2re, w2im, twre, twim = ct_plan.ct_constants(n, inverse=True)
    w2 = (w2re + 1j * w2im).astype(np.complex64)
    tw = (twre + 1j * twim).astype(np.complex64)
    q = np.concatenate([np.arange(n2 - nneg, n2), np.arange(npos)])  # window rows
    chunk = gcc_pair.chunk_rows(threads, n1)
    warps = threads // WARP
    z = np.zeros((pairs, nneg + npos, n1), np.complex64)
    for r0 in range(0, n2, chunk):
        rows = min(chunk, n2 - r0)
        c = np.empty((pairs, rows, n1), np.complex64)
        for w in range(warps):  # warp w takes chunk rows w, w + warps, ...
            rl = np.arange(w, rows, warps)
            c[:, rl] = row_transform(r[:, r0 + rl]) * tw[r0 + rl]
        for rl in range(rows):  # the fold, k2 ascending
            z = z + w2[q, r0 + rl][None, :, None] * c[:, rl][:, None, :]
    mags = (np.sqrt(z.real * z.real + z.imag * z.imag) * f32(1.0 / n)).reshape(pairs, -1)
    return mags[:, nneg * n1 - max_lag: nneg * n1 + max_lag + 1]


@pytest.mark.parametrize("n1", [128, 256])
def test_warp_schedule_partners_twiddles_and_positions(n1):
    p = n1 // WARP
    pos = positions(n1)
    assert sorted(pos.ravel()) == list(range(n1))
    np.testing.assert_array_equal(  # brev(l + 32·i) = P·brev5(l) + brev(i)
        pos, [[p * _brev(lane, 5) + _brev(i, p.bit_length() - 1) for i in range(p)] for lane in LANES]
    )
    t = LANES[:, None] + WARP * np.arange(p)  # the position of point i of lane l
    half = lambda h: (t % h) * (n1 // 2 // h)  # the DIF exponent of the pair (t, t + h)
    hs, slots = [], []
    for h, g, pairs in register_stages(n1):
        hs.append(h)
        for i, j, e in pairs:
            np.testing.assert_array_equal(t[:, i + g], t[:, i] + h)
            np.testing.assert_array_equal(e, half(h)[:, i])
            slots.append(p - h // 16 + j)
    assert sorted(set(slots)) == list(range(p - 1))  # RowTwiddles::reg, one slot per (h, j)
    for h, partner, top, e in lane_stages(n1):
        hs.append(h)
        np.testing.assert_array_equal(partner[partner], LANES)
        np.testing.assert_array_equal(top[partner], ~top)
        np.testing.assert_array_equal(t[partner], t ^ h)  # point i meets point i of lane l ^ h
        assert ((t & h) == 0)[top].all() and top.sum() == WARP // 2
        np.testing.assert_array_equal(np.broadcast_to(e[:, None], t.shape), half(h))  # one per lane
        assert e.max() < n1 // 2
    assert hs == [n1 >> s for s in range(1, n1.bit_length())]  # h = n1/2 .. 1


def _max_bank_load(words, width):
    """The most accesses any bank gets from lanes writing ``width``
    consecutive 32-bit words from each of ``words``."""
    banks = ((np.asarray(words)[:, None] + np.arange(width)) % BANKS).ravel()
    return np.bincount(banks, minlength=BANKS).max()


@pytest.mark.parametrize("n1", [128, 256])
def test_chunk_buffer_stores_and_fold_reads_are_free_of_bank_conflicts(n1):
    """Each lane stores its P consecutive times from p0 = P·brev5(l) as
    16-byte words (a quarter-warp a wavefront); the fold reads 32
    consecutive times as 8-byte words (a half-warp a wavefront)."""
    p = n1 // WARP
    assert sorted(swz(np.arange(n1), p)) == list(range(n1))
    p0 = p * np.array([_brev(lane, 5) for lane in LANES])
    for q in range(0, p, 2):
        word = 2 * swz(p0 + q, p)
        assert (word % 4 == 0).all() and (swz(p0 + q + 1, p) == swz(p0 + q, p) + 1).all()
        for quarter in range(4):
            lanes = slice(8 * quarter, 8 * quarter + 8)
            assert _max_bank_load(word[lanes], 4) == 1
            assert _max_bank_load(2 * (p0 + q)[lanes], 4) == 8  # what the swizzle removes
    for base in range(0, n1, WARP):
        word = 2 * swz(base + LANES, p)
        for half in range(2):
            assert _max_bank_load(word[16 * half:16 * half + 16], 2) == 1


def test_pair_parts_edits_match_the_sources():
    """``tools/pair_parts.py`` times the kernels with parts taken out by
    text edits of ``csrc/gcc_pair.cuh``: each edit must still match."""
    from radio_mapper_tpu_torch.tools import pair_parts

    for parts in pair_parts.VARIANTS.values():
        src = pair_parts.variant_sources(parts)
        assert set(src) == set(pair_parts.SOURCES)


@pytest.mark.parametrize("n1,nfft", [(128, 5120), (128, 17408), (256, 34816)])
def test_warp_fft_equals_ifft_and_the_w1_dft(n1, nfft):
    assert ct_plan.ct_split(nfft)[0] == n1
    rng = np.random.default_rng(n1)
    r = (rng.normal(size=(6, n1)) + 1j * rng.normal(size=(6, n1))).astype(np.complex64)
    r[3] *= 1e3
    r[4, 17] += 300.0  # a strong bin
    ours = row_transform(r)
    scale = np.abs(r).sum(axis=-1, keepdims=True)  # the largest |E| a row can reach
    ref = np.fft.ifft(r.astype(np.complex128)) * n1
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-6 * scale).all()
    _, _, w1re, w1im, *_ = ct_plan.ct_constants(nfft, inverse=True)
    direct = r.astype(np.complex128) @ (w1re.astype(np.float64) + 1j * w1im)
    assert (np.abs(ours - direct).max(axis=-1, keepdims=True) <= 1e-6 * scale).all()


@pytest.mark.parametrize("n1", [128, 256])
def test_inverse_radix_table_is_float64_rounded_once(n1):
    t = ct_plan.inverse_radix_table(n1)
    w = np.exp(2j * np.pi * np.arange(n1 // 2) / n1)
    assert t.dtype == np.float32 and t.shape == (n1 // 2, 2)
    np.testing.assert_array_equal(t[:, 0], w.real.astype(np.float32))
    np.testing.assert_array_equal(t[:, 1], w.imag.astype(np.float32))
    if n1 == 128:  # the conjugate of K3's forward table
        w128 = ct_plan.radix_tables(5120).w1
        np.testing.assert_array_equal(t, w128 * np.array([1, -1], np.float32))


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("nfft,max_lag", CASES)
def test_pair_body_replica_matches_plain(nfft, max_lag, gate):
    b, eps = 3, 0.05
    sre, sim, smax = correlated_spectra(1, b, nfft, nfft % 97)
    sre, sim, smax = sre[0], sim[0], smax[0]
    pi, pj = np.array([0, 0, 1, 2]), np.array([1, 2, 2, 0])
    x = [np.ascontiguousarray(a[idx]) for idx in (pi, pj) for a in (sre, sim)]
    s2 = pair_gate_scales(smax, pi, pj) if gate == "l2rx" else None
    k2 = pair_body(x[0], x[1], x[2], x[3], s2, max_lag, eps, gate, threads=gcc_pair.THREADS)
    k8 = pair_body(x[0], x[1], x[2], x[3], s2, max_lag, eps, gate, threads=channel_step.THREADS)
    np.testing.assert_array_equal(k2, k8)  # the fold's sums do not depend on the chunk
    ref = gcc_pair._whiten_invert_plain(
        *(torch.from_numpy(a) for a in x), None if s2 is None else torch.from_numpy(s2), max_lag, eps, gate
    ).numpy()
    assert k2.shape == ref.shape == (len(pi), 2 * max_lag + 1)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(k2 - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()
    np.testing.assert_array_equal(k2.argmax(-1), ref.argmax(-1))


def test_geometry_takes_n1_128_and_256_and_keeps_shared_memory():
    """The kernels' inner lengths and shared memory: no more than the
    direct-DFT body took at the main paths' shapes (it is the same
    formula), and K8's pair buffers inside its row; the mixed-radix inner
    lengths are taken too (the wide body, one CT row a warp a chunk), and
    a split outside them raises."""
    assert gcc_pair._geometry(17408, 512, "K2") == (128, 136, 4, 5)
    assert gcc_pair._geometry(5120, 128, "K5") == (128, 40, 1, 2)
    assert gcc_pair._geometry(34816, 512, "K2") == (256, 136, 2, 3)
    assert gcc_pair.smem_bytes(128, 4, 5) == 25_600  # [128, 8, 17408], L 512
    assert gcc_pair.smem_bytes(128, 1, 2) == 19_456  # [16, 64, 5120], L 128
    assert gcc_pair.smem_bytes(128, 4, 5, channel_step.THREADS) == 41_984 <= 17408 * 8  # K8
    n = next(n for n in range(128, 1 << 20, 128) if ct_plan.ct_supported(n) and ct_plan.ct_split(n)[0] == 384)
    assert gcc_pair._geometry(n, 64, "K2")[0] == 384 and gcc_pair.PAIR_N1 == (128, 256, 384, 640, 896)
    assert gcc_pair.wide_plan(384, n // 384, 1, 1, 1).rows == 8  # the wide body: 8 warps, one row each
    n = next(n for n in range(128, 1 << 20, 128) if ct_plan.ct_supported(n) and ct_plan.ct_split(n)[0] == 512)
    with pytest.raises(ValueError, match="n1 in"):
        gcc_pair._geometry(n, 64, "K2")
