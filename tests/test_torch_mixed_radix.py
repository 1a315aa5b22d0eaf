"""The mixed-radix warp FFT of step C and of the GCC pair body, replayed in
numpy on the CPU.

Both run an n1 = 32·P point transform in one warp, P points a lane, as
five radix-2 stages across lanes (``__shfl_xor_sync``) and a P-point
transform in registers. For P = 4 and 8 that is radix-2 throughout; for
P = 4q (q = 3, 5, 7: n1 = 384, 640, 896) the register part is two radix-2
stages and then the direct q-point DFT of each of four blocks of q
registers (``csrc/ct_fft.cuh`` ``mixed_regs``, ``q_roots``, ``q_dfts``):

- forward (step C of kernel K3's long rows, ``step_c_row``): lane l holds
  positions P·l + i; the lane stages of half-size h = n1/2 .. P pair lane
  l with l ^ (h/P), twiddle W_n1^(((P·l + i) mod h)·n1/(2h)); register i
  then holds bin ``digit(i)·32 + brev5(l)``;
- inverse (the wide pair body of K2, K5, K6, ``csrc/gcc_pair_wide.cuh``
  ``inverse_row_fft_wide``): lane l
  holds bins l + 32·i; the register part comes first, with twiddles that
  depend on the lane (the two radix-2 stages W^−(l + 32j) and
  W^−(2(l + 32j)), then W^−(4·l·u) after output u of each q-point DFT),
  then the lane stages; register i then holds time
  ``P·brev5(l) + digit(i)``.

``digit(i)`` is the register transform's output order: brev(i) for P a
power of two, ``brev2(i // q) + 4·(i mod q)`` for P = 4q. The replicas
run the kernels' order of operations in complex64 and must equal
``np.fft.fft`` / ``np.fft.ifft``·n1 within 1e-5 of the row's max |X|
(ten float32 stages and a direct DFT of at most 7 points). No JAX here.
"""

import numpy as np
import pytest

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

WARP = 32
LANES = np.arange(WARP)
N1S = (128, 256, 384, 640, 896)
MIXED = (384, 640, 896)


def _brev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _c64(pairs: np.ndarray) -> np.ndarray:
    return (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)


def _pow2(p: int) -> bool:
    return p & (p - 1) == 0


def digit(p: int, i: int) -> int:
    """``rm_fft::digit<P>``: the output register i of the P-point transform holds."""
    if _pow2(p):
        return _brev(i, p.bit_length() - 1)
    q = p // 4
    return _brev(i // q, 2) + 4 * (i % q)


def digit_inv(p: int, m: int) -> int:
    """``rm_fft::digit_inv<P>``: the register that holds output m."""
    if _pow2(p):
        return _brev(m, p.bit_length() - 1)
    q = p // 4
    return _brev(m % 4, 2) * q + m // 4


def q_roots(q: int, w: np.ndarray, nw: int) -> np.ndarray:
    """``q_roots<q, nw>``: W_q^m from the table ``w`` of W_nw^e (e < nw/2),
    conjugated above q/2 (the inverse's roots from the inverse table)."""
    wq = np.ones(q, np.complex64)
    for m in range(1, q // 2 + 1):
        wq[m] = w[m * (nw // q)]
        wq[q - m] = np.conj(wq[m])
    return wq


def q_dfts(v: np.ndarray, wq: np.ndarray) -> np.ndarray:
    """``q_dfts<P>`` on registers ``v [..., P]``: the direct q-point DFT of
    each block of q registers, in place, in the kernel's order of sums."""
    q = len(wq)
    out = v.copy()
    for b in range(4):
        x = v[..., b * q:(b + 1) * q]
        for u in range(q):
            acc = x[..., 0].copy()
            for t in range(1, q):
                acc = acc + (x[..., t] if (t * u) % q == 0 else x[..., t] * wq[(t * u) % q])
            out[..., b * q + u] = acc
    return out


def register_transform(v: np.ndarray, w: np.ndarray, nw: int) -> np.ndarray:
    """The forward register part on ``v [..., P]`` (table ``w`` of W_nw^e):
    ``dif_regs<P, nw>`` for P a power of two, ``mixed_regs<P, nw>`` for
    P = 4q. Register i then holds output digit(i)."""
    p = v.shape[-1]
    v = v.copy()
    hs = [p >> s for s in range(1, p.bit_length())] if _pow2(p) else [p // 2, p // 4]
    for h in hs:
        for t in range(p):
            if t % (2 * h) >= h:
                continue
            a, b = v[..., t].copy(), v[..., t + h].copy()
            e = (t % h) * (nw // 2 // h)
            v[..., t] = a + b
            v[..., t + h] = (a - b) * w[e] if e else a - b
    if not _pow2(p):
        v = q_dfts(v, q_roots(p // 4, w, nw))
    return v


def warp_forward_fft(v: np.ndarray, n1: int) -> np.ndarray:
    """``step_c_row<n1>`` on rows held as ``v [..., 32, P]`` (lane l,
    register i = position P·l + i); returns the registers after it."""
    p = n1 // WARP
    w1 = _c64(ct_plan._roots(np.arange(n1 // 2), n1))
    v = v.copy()
    pos = p * LANES[:, None] + np.arange(p)
    h = n1 // 2
    while h >= p:
        d = h // p
        w = v[..., LANES ^ d, :]  # __shfl_xor_sync
        e = (pos % h) * (n1 // 2 // h)
        v = np.where(((LANES & d) == 0)[:, None], v + w, (w - v) * w1[e])
        h //= 2
    return register_transform(v, w1, n1)


def forward_bins(n1: int) -> np.ndarray:
    """``[32, P]``: the bin register i of lane l holds after step C."""
    p = n1 // WARP
    return np.array([[digit(p, i) * WARP + _brev(lane, 5) for i in range(p)] for lane in LANES])


def inverse_lane_twiddles(n1: int) -> np.ndarray:
    """``reg_twiddle`` of every lane for P = 4q, ``[32, P − 1]``
    complex64: W^−(l + 32j) (j < 2q), W^−(2(l + 32j)) (j < q), then
    W^−(4·l·u) for 0 < u < q, from ``ct_plan.inverse_radix_table``."""
    p, q = n1 // WARP, n1 // 128
    wi = _c64(ct_plan.inverse_radix_table(n1))
    reg = np.empty((WARP, p - 1), np.complex64)
    for lane in LANES:
        for j in range(2 * q):
            reg[lane, j] = wi[lane + WARP * j]
        for j in range(q):
            reg[lane, 2 * q + j] = wi[2 * (lane + WARP * j)]
        for u in range(1, q):
            e = (4 * lane * u) % n1
            reg[lane, 3 * q + u - 1] = wi[e] if e < n1 // 2 else -wi[e - n1 // 2]
    return reg


def warp_inverse_mixed(v: np.ndarray, n1: int) -> np.ndarray:
    """``inverse_row_fft_wide<n1>`` for P = 4q on rows held as ``v [..., 32, P]``
    (lane l, point i = bin l + 32·i); returns the registers after it."""
    p, q = n1 // WARP, n1 // 128
    wi = _c64(ct_plan.inverse_radix_table(n1))
    reg = inverse_lane_twiddles(n1)
    v = v.copy()
    for g, base in ((2 * q, 0), (q, 2 * q)):  # the stages h = n1/2 and n1/4
        for i in range(p):
            if i % (2 * g) >= g:
                continue
            a, b = v[..., i].copy(), v[..., i + g].copy()
            v[..., i] = a + b
            v[..., i + g] = (a - b) * reg[:, base + i % g]
    v = q_dfts(v, q_roots(q, wi, n1))
    for b in range(4):
        for u in range(1, q):
            v[..., b * q + u] = v[..., b * q + u] * reg[:, 3 * q + u - 1]
    for s in range(5):  # the lane stages, as for P = 4 and 8
        h = 16 >> s
        e = (LANES & (h - 1)) * (n1 // 2 // h)
        w = v[..., LANES ^ h, :]
        v = np.where(((LANES & h) == 0)[:, None], v + w, (w - v) * wi[e][:, None])
    return v


def inverse_times(n1: int) -> np.ndarray:
    """``[32, P]``: the time point i of lane l holds after the inverse."""
    p = n1 // WARP
    return np.array([[p * _brev(lane, 5) + digit(p, i) for i in range(p)] for lane in LANES])


def _rows(n1, seed, rows=6):
    rng = np.random.default_rng(seed)
    r = (rng.normal(size=(rows, n1)) + 1j * rng.normal(size=(rows, n1))).astype(np.complex64)
    r[3] *= 1e3
    r[4, 17] += 300.0  # a strong bin
    r[5] += 30 * np.exp(2j * np.pi * 37 * np.arange(n1) / n1)  # a strong tone
    return r


@pytest.mark.parametrize("p", [4, 8, 12, 20, 28])
def test_digit_maps_are_inverse_permutations(p):
    d = [digit(p, i) for i in range(p)]
    assert sorted(d) == list(range(p))
    assert [digit(p, digit_inv(p, m)) for m in range(p)] == list(range(p))
    if not _pow2(p):  # block b of q registers holds the outputs of residue brev2(b) mod 4
        q = p // 4
        assert [d[b * q] % 4 for b in range(4)] == [0, 2, 1, 3]


@pytest.mark.parametrize("n1", N1S)
def test_forward_step_c_replica_equals_numpy_fft(n1):
    x = _rows(n1, n1)
    p = n1 // WARP
    v = warp_forward_fft(x.reshape(-1, WARP, p), n1)  # lane l holds positions P·l + i
    ours = np.empty_like(x)
    ours[:, forward_bins(n1)] = v
    ref = np.fft.fft(x.astype(np.complex128))
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()
    assert sorted(forward_bins(n1).ravel()) == list(range(n1))


@pytest.mark.parametrize("n1", N1S)
def test_forward_ct_address_covers_the_ct_rows(n1):
    """``ct_address<n1>``: slot row sr = s + r·k to CT row k + a·s, column
    digit(i)·32 + brev5(l); over a length's slot rows every CT address
    once, and each register i's 32 lanes on 32 consecutive columns."""
    a, r = 8, 17
    n2 = a * r
    p = n1 // WARP
    cols = forward_bins(n1)
    seen = np.zeros(n1 * n2, np.int64)
    for sr in range(n2):
        k, s = divmod(sr, r)
        seen[(k + a * s) * n1 + cols.ravel()] += 1
    np.testing.assert_array_equal(seen, 1)
    for i in range(p):
        assert sorted(cols[:, i]) == list(range(WARP * digit(p, i), WARP * (digit(p, i) + 1)))


@pytest.mark.parametrize("n1", MIXED)
def test_inverse_pair_fft_replica_equals_numpy_ifft(n1):
    r = _rows(n1, n1 + 1)
    p = n1 // WARP
    v = warp_inverse_mixed(r.reshape(-1, p, WARP).swapaxes(-1, -2), n1)  # lane l holds bins l + 32·i
    ours = np.empty_like(r)
    ours[:, inverse_times(n1)] = v
    ref = np.fft.ifft(r.astype(np.complex128)) * n1
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()
    assert sorted(inverse_times(n1).ravel()) == list(range(n1))


@pytest.mark.parametrize("n1", MIXED)
def test_inverse_lane_twiddles_fit_the_table(n1):
    """Every exponent the lanes read lies in the half table (e < n1/2), and
    the sub-problem twiddle W^−(4lu) folded through −W^−(e − n1/2) equals
    the float64 root rounded once up to the sign flip's exactness."""
    p, q = n1 // WARP, n1 // 128
    assert (LANES[:, None] + WARP * np.arange(2 * q)).max() < n1 // 2
    assert (2 * (LANES[:, None] + WARP * np.arange(q))).max() < n1 // 2
    assert (q // 2) * (n1 // q) < n1 // 2  # the q-point roots read e < n1/2
    reg = inverse_lane_twiddles(n1)
    u = np.arange(1, q)
    exact = np.exp(2j * np.pi * (4 * LANES[:, None] * u) / n1)
    np.testing.assert_allclose(reg[:, 3 * q:], exact, atol=1e-7)
    assert reg.shape == (WARP, p - 1)


@pytest.mark.parametrize("n1", MIXED)
def test_mixed_chunk_buffer_swizzle_is_a_permutation(n1):
    """The pair body's C rows in the chunk buffer (``rm_wide::swz_wide``:
    p's two low bits XOR (p / 8P) mod 4, bits 3..4 XOR the row mod 4) stay
    a permutation of each row at P = 12, 20, 28, and a lane's P times from
    p0 = P·brev5(l) (a multiple of 4) share p0's (p / 8P) mod 4, so the
    store's shortcut (p0 + (d ^ kb)) ^ 8·(row mod 4) holds."""
    p = n1 // WARP
    t = np.arange(n1)
    for row in range(4):
        sw = (t ^ ((t // (8 * p)) & 3)) ^ (row << 3)
        assert sorted(sw) == list(range(n1))
    p0 = p * np.array([_brev(lane, 5) for lane in LANES])
    assert (p0 % 4 == 0).all()
    for d in range(p):
        kb = (p0 // (8 * p)) & 3
        np.testing.assert_array_equal((p0 + d) ^ (((p0 + d) // (8 * p)) & 3), p0 + (d ^ kb))


def test_pair_geometry_takes_the_mixed_lengths_within_shared_memory():
    """The mixed lengths run the pair body (``csrc/gcc_pair_wide.cuh``, as
    n1 = 128 and 256 do, with 16 and 8 CT rows a chunk for one pair, 8 for
    two): one pair a block
    on 8 CT rows a chunk, 4 at n1 = 896 where 8 do not fit twice, and its
    shared memory stays inside the card's 227 KB at the largest inner
    length and lag window the planned lengths reach."""
    assert [gcc_pair.CHUNK_ROWS[n1][:2] for n1 in N1S[:2]] == [(16, 8), (8, 8)]
    assert gcc_pair._geometry(121_856, 600, "K2") == (896, 136, 1, 1)
    plan = gcc_pair.wide_plan(896, 136, 1, 1, 1)
    assert (plan.rows, plan.smem) == (4, 132_888)
    n1, n2, nneg, npos = gcc_pair._geometry(129_024, 2048, "K5")  # 384·336, the widest window planned
    assert gcc_pair.wide_plan(n1, n2, nneg, npos, 1).smem <= gcc_pair.SMEM_LIMIT
