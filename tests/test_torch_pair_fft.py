"""The warp FFT of the GCC pair body at n1 = 128 and 256, and the whole
body under each kernel's launch plan, replayed in numpy on the CPU.

``csrc/gcc_pair_wide.cuh`` (``wide_pair_body``; the rest of the body is
replayed in ``tests/test_torch_pair_wide.py``) turns a pair's CT-order
spectra X, Y (bin k = k2 + n2·k1 at m = k2·n1 + k1) into its lag window.
Its inner transform at n1 = 128 and 256:

- one warp per (pair, CT row k2) job, point i of lane l holding bin
  k1 = l + 32·i (i < P = n1/32): R = X·conj(Y), whitened by the gate;
- the inner inverse n1-point FFT, radix-2 DIF with conjugate twiddles
  W_n1^−e, e = (t mod h)·(n1/2)/h for the pair (t, t + h): the stages of
  half-size h = n1/2 .. 32 pair points i and i + h/32 of a lane in
  registers (their twiddles a table slot P − h/16 + j, j = i mod h/32, per
  lane), the stages h = 16 .. 1 pair lane l with lane l ^ h (the lane
  whose bit h is clear keeps a + b, its partner (a − b)·W); each lane's
  exponents depend on the lane and i, never on the row; point i of lane l
  then holds E[brev(l + 32·i)] = E[P·brev5(l) + brev(i)].

The replica runs exactly that in float32/complex64 and must equal
``np.fft.ifft``·n1 and the direct DFT of the ``w1`` table row by row. The
whole body (``test_torch_pair_wide.wide_body``) under the plans of K2
(tiles of two pairs), K5 and K6 (one pair a block) and, at n1 = 128 up
to 24576, kernel K8 (its row's shared memory, 512 threads) must give
identical windows — each folds the same k-steps in k2 order — and equal
``gcc_pair._whiten_invert_plain`` (the plain version the kernels are held
to) within 1e-5 of each window's max, for the four gates, at nfft 5120 (L
128) and 17408 (L 512), n1 = 128, 34816 (L 512), n1 = 256, and at 52224,
87040 and 121856 (L 600), n1 = 384, 640 and 896. The text edits of
``tools/pair_parts.py`` are held to the current sources. No JAX here.
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


def pair_body(xr, xi, yr, yi, s2, max_lag, eps, gate, kernel):
    """``wide_pair_body`` on float32 pair spectra ``[pairs, n]`` (CT
    order) as ``kernel`` ("K2", "K5" or "K8") plans its launch; ``s2
    [pairs]`` is the l2rx gate scale."""
    from radio_mapper_tpu_torch.ops.cuda import channel_step
    from test_torch_pair_wide import wide_body

    n = xr.shape[-1]
    nneg, npos = gcc_pair.window_rows(n, max_lag)
    plan = channel_step.pair_plan(n, nneg, npos) if kernel == "K8" else None
    pairs = {"K2": 2, "K5": 1, "K8": 2}[kernel]  # K5 here one pair a block
    return wide_body(xr, xi, yr, yi, s2, max_lag, eps, gate, pairs=pairs, plan=plan)


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


def test_pair_parts_edits_match_the_sources():
    """``tools/pair_parts.py`` times the kernels with parts taken out by
    text edits of ``csrc/gcc_pair_wide.cuh``: each edit must still match."""
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
    k2 = pair_body(x[0], x[1], x[2], x[3], s2, max_lag, eps, gate, "K2")
    k5 = pair_body(x[0], x[1], x[2], x[3], s2, max_lag, eps, gate, "K5")
    np.testing.assert_array_equal(k2, k5)  # the fold's sums do not depend on the chunk or the tile
    if ct_plan.ct_split(nfft)[0] == 128:  # K8's cluster design: nfft <= 24576
        np.testing.assert_array_equal(k2, pair_body(x[0], x[1], x[2], x[3], s2, max_lag, eps, gate, "K8"))
    ref = gcc_pair._whiten_invert_plain(
        *(torch.from_numpy(a) for a in x), None if s2 is None else torch.from_numpy(s2), max_lag, eps, gate
    ).numpy()
    assert k2.shape == ref.shape == (len(pi), 2 * max_lag + 1)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(k2 - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()
    np.testing.assert_array_equal(k2.argmax(-1), ref.argmax(-1))


def test_geometry_takes_n1_128_and_256_and_keeps_shared_memory():
    """The kernels' inner lengths and shared memory at the main paths'
    shapes: the flagship's K2 and the wideband K5 in three blocks an SM,
    K8's pair buffers inside its row; the mixed-radix inner lengths are
    taken too, and a split outside them raises."""
    assert gcc_pair._geometry(17408, 512, "K2") == (128, 136, 4, 5)
    assert gcc_pair._geometry(5120, 128, "K5") == (128, 40, 1, 2)
    assert gcc_pair._geometry(34816, 512, "K2") == (256, 136, 2, 3)
    assert gcc_pair.wide_plan(128, 136, 4, 5, 2).smem == 66_592  # K2 [128, 8, 17408], L 512
    assert gcc_pair.wide_plan(128, 40, 1, 2, gcc_pair.TILE_PAIRS).smem == 62_624  # K5 [16, 64, 5120], L 128
    assert channel_step.pair_plan(17408, 4, 5).smem == 115_744 <= 17408 * 8  # K8: 16 rows a chunk
    n = next(n for n in range(128, 1 << 20, 128) if ct_plan.ct_supported(n) and ct_plan.ct_split(n)[0] == 384)
    assert gcc_pair._geometry(n, 64, "K2")[0] == 384 and gcc_pair.PAIR_N1 == (128, 256, 384, 640, 896)
    assert gcc_pair.wide_plan(384, n // 384, 1, 1, 1).rows == 8  # one pair: 8 rows a chunk
    n = next(n for n in range(128, 1 << 20, 128) if ct_plan.ct_supported(n) and ct_plan.ct_split(n)[0] == 512)
    with pytest.raises(ValueError, match="n1 in"):
        gcc_pair._geometry(n, 64, "K2")
