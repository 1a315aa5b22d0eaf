"""Kernels K2, K5 and K6: whitening × inverse DFT × lag window.

Three entries into one CUDA body (``radio_mapper_tpu_torch/csrc/gcc_pair.cu``
around ``csrc/gcc_pair_wide.cuh``'s ``wide_pair_body``, which kernel K8's
pair half shares), each with its plain PyTorch version and its own launch
counter:

- **K2** :func:`gcc_pair_lag_mags` replaces
  ``radio_mapper_tpu/ops/pallas/gcc_kernel.py::gcc_pair_lag_mags``: all
  pairs of every channel, the "l2rx" gate scale from the per-receiver
  maxima ``row_smax`` that kernel K1 emits (the flagship path);
- **K5** :func:`gcc_pairs_onehot_lag_mags` replaces
  ``gcc_kernel.gcc_pairs_onehot_lag_mags``: the pair list is data and the
  gate scale ``s2`` is given per pair; a leading subchannel axis runs in
  the same launch (the wideband path's default route);
- **K6** :func:`gcc_rows_lag_mags` replaces ``gcc_kernel.gcc_rows_lag_mags``:
  row k of X pairs with row k of Y, pre-gathered by the caller (the
  wideband route when :func:`onehot_pairs_enabled` says no).

Design, at every inner length n1 = 128, 256, 384, 640, 896 of the CT split
(one kernel instantiated for each length and kind): K2 takes tiles of two
pairs of a channel that share a receiver (:func:`wide_tiles`), K5 tiles
of up to :data:`TILE_PAIRS` where its window is one n-tile, K6 one pair;
pairs are read by index straight from the CT-order spectra (the
TPU's resident spectra and one-hot matmul gather are a VMEM/MXU layout
device with no use here; one subchannel's 64 spectra, 2.6 MB, stay in the
50 MB L2). The tile's CT rows arrive by bulk copies (``cp.async.bulk``
completing on an mbarrier) into a double buffer in shared memory, a chunk
of :func:`wide_plan`'s rows ahead; one warp a (pair, row) forms and
whitens R = X·conj(Y) from shared memory and runs the warp FFT (radix-2
stages in registers for n1 = 128, 256; two radix-2 stages and direct
q-point DFTs, q = 3, 5, 7, for the mixed lengths; then five stages across
lanes by ``__shfl_xor_sync``) and stores C = E·TW, TW formed from two
small tables (:func:`wide_twiddle_factors`); the window rows (``ceil(L/n1)``
tail rows and ``L//n1 + 1`` head rows) are folded on the tensor cores,
``mma.sync.m16n8k8`` TF32 in the 3xTF32 split, each k-step of 4 CT rows
summed on the tensor cores and added to FP32 accumulators in registers,
in k2 order whatever the chunk (so kernel K8, which runs the same body on
512 threads, gives the same windows bit for bit), the block's rows of W2
staged once in shared memory; the window's n-tiles past a block's :data:`WIDE_SLOTS` go to more
blocks along ``blockIdx.y``. :func:`wide_info` reads each kernel's
registers, local memory and resident blocks on the card.
``tests/test_torch_pair_wide.py``, ``tests/test_torch_pair_fft.py`` and
``tests/test_torch_mixed_radix.py`` replay it in numpy.

Whitening (``gcc_kernel._whiten``, chosen by :func:`set_phat_gate` and
``weighting``): "phat" takes the gate of the knob — "l2rx" (default)
R·rsqrt(|R|² + ε²·s2 + 1e-30) with s2 = max|X_i|²·max|Y_j|² from the
per-receiver maxima, "l2" the same with s2 = max|R|² of the pair, "l1"
R / (|R| + ε·max|R| + 1e-30); "l2rx" without gate scales runs as "l2",
as in the reference. "cc" is not whitened. The per-pair gates need the
pair's maximum first: one more pass over X and Y.

What bounds it on the H100: with the inner transform an FFT
(5·n·log2(n1) FLOP a pair), the outer fold, 8·n·(window rows) FLOP a
pair (1.25 M FLOP at nfft 17408 / max_lag 512, 0.12 M at 5120 / 128), is
the largest part of the work, on tensor cores three times over for the
split; each pair reads two spectra (one and a half in K2's tiles), mostly
L2 hits since a channel's B spectra are shared by all its pairs. Left for
later PRs: fusing the forward transform into this kernel so spectra stay
on chip (kernel K8 does the latter through a scratch at n1 = 128).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build
from radio_mapper_tpu_torch.utils import spans

launch_count = 0  # K2 launches (not of the plain version)
onehot_launch_count = 0  # K5 launches
rows_launch_count = 0  # K6 launches

THREADS = 256  # must match rm_wide::THREADS (the K2, K5 and K6 blocks)
PAIR_N1 = ct_plan.RADIX_N1  # the inner lengths of the pair body (one kernel a length and kind)
# rm_wide::SLOTS<n1>: accumulator (pair, n-tile) slots a block, 24 or 32
# accumulator registers a thread of a 256-thread block
WIDE_SLOTS = {128: 6, 256: 4, 384: 2, 640: 2, 896: 2}
# CT rows a chunk for one pair, two pairs and more a block (a multiple of 4:
# a k-step of the fold): at n1 = 128 K2's 8 rows keep three blocks an SM
# (16 rows would keep two), K5's tiles of six take 4
CHUNK_ROWS = {128: (16, 8, 4), 256: (8, 8, 4), 384: (8, 4, 4), 640: (8, 4, 4), 896: (8, 4, 4)}
TILE_PAIRS = 6  # rm_wide::MAX_PAIRS: the most pairs a tile (K5's at one n-tile a window)
TILE_INTS = (TILE_PAIRS + 1) + 1 + 2 * TILE_PAIRS  # rm_wide::TILE_INTS: a row of wide_tiles
WIDE_TW_LO = 256  # rm_wide::TW_LO: W_n^e = W_n^(256·(e // 256))·W_n^(e % 256)
WIDE_KINDS = {"K2": 0, "K5": 1, "K6": 2}  # rm_gcc_pair_info's kind
SMEM_LIMIT = 232_448  # H100 per-block shared memory
WIDE_STATIC_SMEM = 1024  # room left for the kernels' static shared memory (the tile, barriers)

_K2_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
_K6_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
_INFO_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]

WEIGHTINGS = ("phat", "cc")  # gcc_kernel.WEIGHTINGS
GATES = ("l2rx", "l2", "l1")  # PHAT gate algebras (gcc_kernel._PHAT_GATE)
_GATE_CODE = {"l2rx": 0, "l2": 1, "l1": 2, "none": 3}  # rm_pair::Gate
_PHAT_GATE = "l2rx"


def set_phat_gate(mode: str) -> None:
    """The PHAT gate of K2/K5/K6 ("l2rx", "l2" or "l1"; the reference's
    ``gcc_kernel.set_phat_gate``). Kernel K8 keeps "l2rx" whatever it is."""
    if mode not in GATES:
        raise ValueError(f"unknown phat gate {mode!r}")
    global _PHAT_GATE
    _PHAT_GATE = mode


def phat_gate() -> str:
    return _PHAT_GATE


def resolve_gate(weighting: str, have_scales: bool) -> str:
    """The whitening a call runs: "none" for "cc"; for "phat" the knob's
    gate, with "l2rx" falling back to "l2" when no gate scales are given
    (``gcc_kernel.py:388-390``)."""
    if weighting not in WEIGHTINGS:
        raise ValueError(f"the fused pair stage supports {WEIGHTINGS}, not {weighting!r}")
    if weighting == "cc":
        return "none"
    if _PHAT_GATE == "l2rx" and not have_scales:
        return "l2"
    return _PHAT_GATE

# Routing of the wideband pair stage between K5 and K6 (the reference's
# trace-time knob ``gcc_kernel.set_onehot_pairs``): "auto" keeps the
# reference's budget, so both packages take the same route for every
# configuration. The budget is the TPU's scoped-VMEM limit for B resident
# spectra; K5 on the H100 holds no spectra on chip and has no such limit.
ONEHOT_BUDGET_BYTES = 8 * 1024 * 1024
_ONEHOT_PAIRS = "auto"


def set_onehot_pairs(mode: str) -> None:
    """Force the wideband pair stage onto K5 ("on"), K6 ("off"), or
    restore the reference's gate ("auto")."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown onehot-pairs mode {mode!r}")
    global _ONEHOT_PAIRS
    _ONEHOT_PAIRS = mode


def onehot_pairs_enabled(num_receivers: int, nfft: int) -> bool:
    """Route to K5? (``gcc_kernel.onehot_pairs_enabled``: the B spectra,
    padded to a multiple of 8 receivers, within 8 MB.)"""
    if _ONEHOT_PAIRS == "off":
        return False
    if _ONEHOT_PAIRS == "on":
        return True
    b_pad = -(-num_receivers // 8) * 8
    return 2 * b_pad * nfft * 4 <= ONEHOT_BUDGET_BYTES


def window_rows(nfft: int, max_lag: int):
    """``(nneg, npos)``: CT time rows (length n1 each) holding lags
    −max_lag..−1 (tail rows) and 0..max_lag (head rows)."""
    n1, _ = ct_plan.ct_split(nfft)
    return -(-max_lag // n1), max_lag // n1 + 1


def device_pairs(pair_i, pair_j, device: torch.device):
    """Host pair lists as int32 tensors on ``device``, copied there once
    per list: cached by the lists' bytes, a cheaper key than a tuple of
    thousands of Python ints."""
    key = lambda p: np.ascontiguousarray(p, dtype=np.int32).tobytes()
    return _pair_tensors(key(pair_i), key(pair_j), device)


@functools.lru_cache(maxsize=16)
def _pair_tensors(pair_i: bytes, pair_j: bytes, device: torch.device):
    to = lambda b: torch.from_numpy(np.frombuffer(b, dtype=np.int32).copy()).to(device)
    return to(pair_i), to(pair_j)


def _check_pairs(pair_i, pair_j, b: int):
    """Host pair lists as equal-length 1-D int arrays inside [0, b)."""
    pi = np.asarray(pair_i)
    pj = np.asarray(pair_j)
    if pi.ndim != 1 or pi.shape != pj.shape or pi.size < 1:
        raise ValueError("pair_i/pair_j must be equal-length 1-D index arrays")
    if pi.min() < 0 or pj.min() < 0 or pi.max() >= b or pj.max() >= b:
        raise ValueError(f"pair indices out of range for {b} receivers")
    return pi, pj


def _check_float32(device: torch.device, **tensors) -> None:
    for name, x in tensors.items():
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} on {x.device}, spectra on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_lag(nfft: int, max_lag: int) -> None:
    if not 0 <= max_lag < nfft // 2:
        raise ValueError(f"max_lag {max_lag} too large for nfft {nfft}")
    ct_plan.ct_split(nfft)


class WidePlan(NamedTuple):
    """A launch of the pair body (``csrc/gcc_pair_wide.cuh``): ``pairs`` a block,
    ``nsrc`` staged sources, ``rows`` CT rows a chunk, ``ntg`` n-tiles a
    pair a block, ``groups`` blocks along ``blockIdx.y``, ``smem`` bytes of
    dynamic shared memory."""

    pairs: int
    nsrc: int
    rows: int
    ntg: int
    groups: int
    smem: int


def twiddle_count(n1: int) -> int:
    """``rm_wide::twiddle_count``: complex floats of the warp FFT's
    twiddle table, [P − 1][32] a lane's register-stage twiddles, for the
    mixed lengths the q roots, then [4][32] the shuffle stages'."""
    p = n1 // 32
    return (p - 1) * 32 + (0 if p & (p - 1) == 0 else n1 // 128) + 4 * 32


def wide_smem_bytes(n1: int, n2: int, nsrc: int, rows: int, ntg: int) -> int:
    """``rm_wide::smem_floats`` in bytes: two buffers of ``nsrc`` sources ×
    2 planes × ``rows`` rows of n1 floats; the block's ``ntg``·4
    window rows of W2 (n2 complex floats each); the warp FFT's twiddle
    table (:func:`twiddle_count`); the inverse twiddle's factors
    (ceil(n/256) + 256 complex floats)."""
    return 4 * (2 * nsrc * 2 * rows * n1 + 2 * ntg * 4 * n2 + 2 * twiddle_count(n1)
                + 2 * (-(-n1 * n2 // WIDE_TW_LO) + WIDE_TW_LO))


def wide_plan(n1: int, n2: int, nneg: int, npos: int, pairs: int,
              limit: int = SMEM_LIMIT - WIDE_STATIC_SMEM, rows: Optional[int] = None) -> WidePlan:
    """How a kernel of the pair body covers a window of ``nneg + npos``
    rows: tiles of up to ``pairs`` pairs (K2 and K8: 2 sharing a receiver;
    K5 in tiles: :data:`TILE_PAIRS`; K5, K6: 1), as many as the tile's
    n-tiles (8 columns: 4 window rows, re and im) fit :data:`WIDE_SLOTS`,
    else one pair a block with its n-tiles that many a block;
    :data:`CHUNK_ROWS` rows a chunk (or ``rows``), 4 fewer at a time
    where they do not fit ``limit`` bytes of shared memory (kernel K8: its
    row's)."""
    if n1 not in PAIR_N1:
        raise ValueError(f"the pair body takes n1 in {PAIR_N1}, not {n1}")
    if not 1 <= pairs <= TILE_PAIRS:
        raise ValueError(f"a tile takes 1 to {TILE_PAIRS} pairs, not {pairs}")
    slots = WIDE_SLOTS[n1]
    nt = -(-(nneg + npos) // 4)
    g = max(1, min(pairs, slots // nt))
    ntg = min(nt, slots // g)
    rows = rows or CHUNK_ROWS[n1][min(g, 3) - 1]
    while rows > 4 and wide_smem_bytes(n1, n2, g + 1, rows, ntg) > limit:
        rows -= 4
    smem = wide_smem_bytes(n1, n2, g + 1, rows, ntg)
    if smem > limit:
        raise ValueError(f"the pair body at {n1}·{n2} needs {smem} B of shared memory (limit {limit})")
    return WidePlan(g, g + 1, rows, ntg, -(-nt // ntg), smem)


def wide_twiddle_factors(n: int) -> np.ndarray:
    """``[ceil(n/256) + 256, 2]`` float32: W_n^(256·a), then W_n^b (b <
    256), W_n = exp(+2πi/n) (the inverse's), float64 rounded once: the
    wide body forms TW[k2][p] = W_n^(k2·p) from them."""
    e = np.concatenate([np.arange(-(-n // WIDE_TW_LO)) * WIDE_TW_LO, np.arange(WIDE_TW_LO)])
    w = np.exp(2j * np.pi * e / n)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def device_twiddle_factors(n: int, device: torch.device) -> torch.Tensor:
    """:func:`wide_twiddle_factors` on ``device``."""
    return torch.from_numpy(wide_twiddle_factors(n)).to(device)


def wide_tiles(pair_i, pair_j, pairs: int) -> np.ndarray:
    """The tile kernel's tiles (``gcc_pair_tile_kernel``, kernel K8):
    int32 ``[T, TILE_INTS]``, each the receivers of slots 0 ..
    ``TILE_PAIRS`` (−1: none), the pairs in the tile, then per pair its
    index and 1 where its X is the leaf (0 past the tile's pairs). Each
    receiver r in turn takes its pairs not yet in a tile, in list order,
    ``pairs`` at a time (and a last group of two or more): a tile shares
    r (slot 0), each pair's other receiver is its leaf (slot g + 1). What
    is left (and every pair, with ``pairs = 1``) is a tile of one. For all
    28 pairs of 8 receivers and ``pairs = 2``: 14 tiles of two, every
    receiver the centre of at least one."""
    pi, pj = (np.asarray(a, np.int64) for a in (pair_i, pair_j))
    tiles, used = [], np.zeros(pi.size, bool)

    def row(recv, ks, flags):
        per_pair = [v for k, f in zip(ks, flags) for v in (k, f)]
        pad = [0] * (2 * TILE_PAIRS - len(per_pair))
        return recv + [-1] * (TILE_PAIRS + 1 - len(recv)) + [len(ks)] + per_pair + pad

    if pairs > 1:
        for r in range(int(max(pi.max(), pj.max())) + 1):
            mine = np.flatnonzero(~used & ((pi == r) | (pj == r))).tolist()
            for a in range(0, len(mine), pairs):
                grp = mine[a:a + pairs]
                if len(grp) < 2:
                    break
                leaf = [int(pj[k] if pi[k] == r else pi[k]) for k in grp]
                tiles.append(row([r] + leaf, grp, [int(pi[k] != r) for k in grp]))
                used[grp] = True
    tiles += [row([int(pi[k]), int(pj[k])], [int(k)], [0]) for k in np.flatnonzero(~used)]
    return np.asarray(tiles, np.int32).reshape(-1, TILE_INTS)


@functools.lru_cache(maxsize=16)
def _tile_tensor(pair_i: bytes, pair_j: bytes, pairs: int, device: torch.device) -> torch.Tensor:
    to = lambda b: np.frombuffer(b, dtype=np.int32)
    return torch.from_numpy(wide_tiles(to(pair_i), to(pair_j), pairs)).to(device)


def device_tiles(pair_i, pair_j, pairs: int, device: torch.device) -> torch.Tensor:
    """:func:`wide_tiles` on ``device``, cached by the lists' bytes."""
    key = lambda p: np.ascontiguousarray(p, dtype=np.int32).tobytes()
    return _tile_tensor(key(pair_i), key(pair_j), pairs, device)


def wide_info(kind: str, n1: int, smem: int) -> dict:
    """What the card makes of a kernel of the pair body
    (``rm_gcc_pair_info``; ``kind`` a key of :data:`WIDE_KINDS`):
    registers a thread, local memory a thread in bytes (0: no spills),
    blocks resident on an SM at ``smem`` bytes of dynamic shared memory,
    static shared memory in bytes."""
    fn = build.kernel("rm_gcc_pair_info", _INFO_ARGTYPES)
    info = (ctypes.c_int * 4)()
    build.check(fn(WIDE_KINDS[kind], n1, smem, ctypes.cast(info, ctypes.c_void_p)), f"pair body info {kind} n1 {n1}")
    return dict(zip(("registers", "local_bytes", "blocks", "static_smem"), info))


def _geometry(n: int, max_lag: int, what: str):
    """``(n1, n2, nneg, npos)`` for a kernel launch; raises where the
    inner length or shared memory does not fit (the shared memory does not
    grow with the window)."""
    n1, n2 = ct_plan.ct_split(n)
    if n1 not in PAIR_N1:
        raise ValueError(f"{what} supports n1 in {PAIR_N1}; nfft {n} = {n1}·{n2}")
    nneg, npos = window_rows(n, max_lag)
    wide_plan(n1, n2, nneg, npos, 1)  # raises where even one pair a block does not fit
    return n1, n2, nneg, npos


def _check_aligned(what: str, **tensors) -> None:
    """The wide body's bulk copies read 16-byte aligned rows."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")


def _tables(n: int, n1: int, device: torch.device):
    """The kernel's ``(wi, w2, twx)``: the inverse radix table of the warp
    FFT, the inverse four-step's outer DFT and the inverse twiddle's two
    factor tables."""
    return (ct_plan.device_inverse_radix_table(n1, device), ct_plan.device_tables(n, True, device).w2,
            device_twiddle_factors(n, device))


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(x: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if x is None else x.data_ptr())


# -- K2: all pairs of every channel, per-receiver gate --------------------


def gcc_pair_lag_mags(
    spec_re: torch.Tensor,
    spec_im: torch.Tensor,
    row_smax: Optional[torch.Tensor],
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    *,
    max_lag: int,
    eps: float = 0.05,
    weighting: str = "phat",
) -> torch.Tensor:
    """Correlation magnitudes |r|/nfft at lags −max_lag..+max_lag.

    Args:
      spec_re/spec_im: float32 ``[C, B, nfft]`` CT-order spectra (K1 output).
      row_smax: float32 ``[C, B]`` per-receiver max linear power (K1
        output) for the "l2rx" gate, or None (the gate then runs as "l2").
      pair_i/pair_j: host int arrays of length P (receiver i, receiver j).
      weighting: "phat" (whitened by the gate of :func:`set_phat_gate`) or
        "cc" (not whitened).
    Returns:
      float32 ``[C, P, 2·max_lag+1]``; lag > 0 ⇒ receiver i heard later.

    CPU tensors go through :func:`gcc_pair_lag_mags_plain`; CUDA tensors
    launch the kernel.
    """
    if spec_re.shape != spec_im.shape or spec_re.dim() != 3:
        raise ValueError(f"need spectra [C, B, nfft], got {tuple(spec_re.shape)}, {tuple(spec_im.shape)}")
    c, b, nfft = spec_re.shape
    if c < 1:
        raise ValueError("need at least one channel")
    gate = resolve_gate(weighting, row_smax is not None)
    if row_smax is not None and row_smax.shape != (c, b):
        raise ValueError(f"row_smax {tuple(row_smax.shape)} does not match spectra [{c}, {b}, ·]")
    scales = dict(row_smax=row_smax) if gate == "l2rx" else {}
    _check_float32(spec_re.device, spec_re=spec_re, spec_im=spec_im, **scales)
    _check_pairs(pair_i, pair_j, b)
    _check_lag(nfft, max_lag)
    if spec_re.device.type == "cpu":
        with device.cpu_single_thread():
            return _k2_plain(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate)
    if spec_re.device.type != "cuda":
        raise ValueError(f"no K2 implementation for device {spec_re.device}")
    return _launch(spec_re, spec_im, row_smax if gate == "l2rx" else None, pair_i, pair_j,
                   max_lag, eps, gate)


def _launch(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate):
    """One launch of K2, counted in :data:`launch_count`, inside the program
    span ``gcc_pair.k2`` (:mod:`..utils.spans`; kernel K8's pair half, which
    calls :func:`launch_k2` itself, records none)."""
    global launch_count
    with spans.span("gcc_pair.k2"):
        out = launch_k2(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate)
    launch_count += 1
    return out


def launch_k2(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate):
    """K2's kernel on checked CUDA spectra under an explicit ``gate``,
    counted by the caller: K2 as one launch of K2, kernel K8's long rows as
    part of one launch of K8. Tiles of two pairs that share a receiver
    (:func:`wide_tiles`; six, where a window is one n-tile, were slower
    at the sharded step's [4096, 8, 3072] on the card: PERF.md §6),
    ``gcc_pair_tile_kernel<n1>``."""
    return _launch_tiles("K2", spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate, 2)


def _launch_tiles(what, spec_re, spec_im, scale, pair_i, pair_j, max_lag, eps, gate, pairs):
    """A launch of the tile kernel on spectra ``[C, B, n]`` in tiles of up
    to ``pairs`` pairs: K2 (``scale`` the per-receiver maxima ``[C, B]``)
    or K5 in tiles (``scale`` s2 ``[C, P]``); windows ``[C, P, 2·max_lag +
    1]``."""
    c, b, n = spec_re.shape
    n1, n2, nneg, npos = _geometry(n, max_lag, what)
    _check_aligned(what, spec_re=spec_re, spec_im=spec_im)
    plan = wide_plan(n1, n2, nneg, npos, pairs)
    entry = "rm_gcc_pair_lag_mags" if what == "K2" else "rm_gcc_pairs_onehot_lag_mags"
    fn = build.kernel(entry, _K2_ARGTYPES)
    wi, w2, tw = _tables(n, n1, spec_re.device)
    tiles = device_tiles(pair_i, pair_j, plan.pairs, spec_re.device)
    p = len(pair_i)
    out = torch.empty((c, p, 2 * max_lag + 1), dtype=torch.float32, device=spec_re.device)
    err = fn(
        _ptr(spec_re), _ptr(spec_im), _ptr(scale), _ptr(tiles),
        _ptr(wi), _ptr(w2), _ptr(tw), _ptr(out),
        c, b, p, tiles.shape[0], n1, n2, nneg, npos, max_lag,
        plan.nsrc, plan.rows, plan.ntg, plan.groups, _GATE_CODE[gate],
        eps * eps, eps, 1.0 / n,
        _stream(spec_re),
    )
    build.check(err, entry)
    return out


def gcc_pair_lag_mags_plain(
    spec_re: torch.Tensor,
    spec_im: torch.Tensor,
    row_smax: Optional[torch.Tensor],
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    *,
    max_lag: int,
    eps: float = 0.05,
    weighting: str = "phat",
) -> torch.Tensor:
    """Plain PyTorch version of K2: the same whitening and four-step
    inverse on the same tables, as batched tensor ops. Same contract as
    :func:`gcc_pair_lag_mags`. On the card it is the comparison only,
    with ``torch.backends.cuda.matmul.allow_tf32 = False`` set by the
    caller (full FP32 products). Through its wrapper on the CPU it runs at one intra-op thread
    (:func:`device.cpu_single_thread`, fault F2)."""
    gate = resolve_gate(weighting, row_smax is not None)
    return _k2_plain(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate)


def _k2_plain(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate):
    """K2's plain body under an explicit ``gate`` (kernel K8's plain
    version passes "l2rx")."""
    pi = torch.as_tensor(np.asarray(pair_i, np.int64), device=spec_re.device)
    pj = torch.as_tensor(np.asarray(pair_j, np.int64), device=spec_re.device)
    s2 = row_smax[:, pi] * row_smax[:, pj] if gate == "l2rx" else None  # ≥ max|R|² per pair
    return _whiten_invert_plain(
        spec_re[:, pi], spec_im[:, pi], spec_re[:, pj], spec_im[:, pj], s2, max_lag, eps, gate
    )


def _whiten(rr, ri, s2, eps, gate):
    """``gcc_kernel._whiten`` on cross-power ``(rr, ri) [..., n]``; ``s2
    [...]`` is used by "l2rx" only."""
    if gate == "none":
        return rr, ri
    p2 = rr * rr + ri * ri
    if gate == "l1":
        mag = p2 * torch.rsqrt(p2 + 1e-30)
        scale = mag.amax(dim=-1, keepdim=True)  # per-pair gate
        inv = 1.0 / (mag + eps * scale + 1e-30)
    else:
        if gate == "l2":
            s2 = p2.amax(dim=-1)  # max|R|² per pair
        inv = torch.rsqrt(p2 + (eps * eps) * s2.unsqueeze(-1) + 1e-30)
    return rr * inv, ri * inv


def _whiten_invert_plain(xr, xi, yr, yi, s2, max_lag, eps, gate):
    """Pair spectra ``[..., n]`` (CT order), gate scales ``s2 [...]`` (or
    None) and the gate → lag windows ``[..., 2·max_lag+1]``: the body all
    the plain versions share."""
    n = xr.shape[-1]
    lead = xr.shape[:-1]
    n1, n2 = ct_plan.ct_split(n)
    nneg, npos = window_rows(n, max_lag)
    t = ct_plan.device_tables(n, True, xr.device)

    rr, ri = _whiten(xr * yr + xi * yi, xi * yr - xr * yi, s2, eps, gate)  # R = X · conj(Y)
    rr = rr.reshape(*lead, n2, n1)
    ri = ri.reshape(*lead, n2, n1)

    # inner inverse DFT over k1, then the inverse twiddle W_n^{+p·k2}
    er = rr @ t.w1re - ri @ t.w1im
    ei = rr @ t.w1im + ri @ t.w1re
    cr = er * t.twre - ei * t.twim
    ci = er * t.twim + ei * t.twre
    # outer inverse DFT over k2, only for the lag-window time rows
    q = torch.cat([torch.arange(n2 - nneg, n2), torch.arange(npos)]).to(xr.device)
    w2r, w2i = t.w2re[q], t.w2im[q]  # [nw, n2]
    zr = w2r @ cr - w2i @ ci  # [..., nw, n1], time q·n1 + p
    zi = w2r @ ci + w2i @ cr
    mags = (torch.sqrt(zr * zr + zi * zi) * (1.0 / n)).reshape(*lead, (nneg + npos) * n1)
    # lags −L..−1 from the tail rows, 0..L from the head rows
    return mags[..., nneg * n1 - max_lag : nneg * n1 + max_lag + 1]


# -- K5: a pair list as data, per-pair gate, optional leading axis --------


def gcc_pairs_onehot_lag_mags(
    spec_re: torch.Tensor,
    spec_im: torch.Tensor,
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    *,
    max_lag: int,
    eps: float = 0.05,
    weighting: str = "phat",
    s2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Lag windows for an arbitrary pair list, gathered in the kernel.

    Args:
      spec_re/spec_im: float32 ``[..., B, nfft]`` CT-order receiver
        spectra (K3 output); the leading axes (the wideband path's M
        subchannels) run in the same launch.
      pair_i/pair_j: host int arrays of length P (copied to the device
        once and cached; the kernel reads them there).
      weighting: "phat" or "cc" (see :func:`resolve_gate`).
      s2: float32 ``[..., P]`` per-pair l2rx gate scales
        (max|X_i|²·max|Y_j|²), or None (the "l2rx" gate then runs as
        "l2").
    Returns:
      float32 ``[..., P, 2·max_lag+1]`` |r| at lags −max_lag..+max_lag.

    CPU tensors go through :func:`gcc_pairs_onehot_lag_mags_plain`; CUDA
    tensors launch the kernel.
    """
    gate = resolve_gate(weighting, s2 is not None)
    if spec_re.shape != spec_im.shape or spec_re.dim() < 2 or spec_re.numel() == 0:
        raise ValueError(f"need spectra [..., B, nfft], got {tuple(spec_re.shape)}, {tuple(spec_im.shape)}")
    *lead, b, nfft = spec_re.shape
    pi, _ = _check_pairs(pair_i, pair_j, b)
    if s2 is not None and s2.shape != (*lead, pi.size):
        raise ValueError(f"s2 {tuple(s2.shape)} does not match [{', '.join(map(str, lead + [pi.size]))}]")
    s2 = s2 if gate == "l2rx" else None
    _check_float32(spec_re.device, spec_re=spec_re, spec_im=spec_im, **({} if s2 is None else {"s2": s2}))
    _check_lag(nfft, max_lag)
    if spec_re.device.type == "cpu":
        with device.cpu_single_thread():
            return gcc_pairs_onehot_lag_mags_plain(
                spec_re, spec_im, pair_i, pair_j, max_lag=max_lag, eps=eps, weighting=weighting, s2=s2
            )
    if spec_re.device.type != "cuda":
        raise ValueError(f"no K5 implementation for device {spec_re.device}")
    return _launch_onehot(spec_re, spec_im, pair_i, pair_j, s2, max_lag, eps, gate)


def _launch_onehot(spec_re, spec_im, pair_i, pair_j, s2, max_lag, eps, gate):
    """K5: the tile kernel with the gate per pair, the leading axes as K2's
    channels, in tiles of up to :data:`TILE_PAIRS` pairs (one pair a
    block is slower on the card: PERF.md §6)."""
    global onehot_launch_count
    *lead, b, n = spec_re.shape
    c = spec_re.numel() // (b * n)
    out = _launch_tiles("K5", spec_re.reshape(c, b, n), spec_im.reshape(c, b, n), s2, pair_i, pair_j, max_lag,
                        eps, gate, TILE_PAIRS)
    onehot_launch_count += 1
    return out.reshape(*lead, *out.shape[1:])


def gcc_pairs_onehot_lag_mags_plain(
    spec_re: torch.Tensor,
    spec_im: torch.Tensor,
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    *,
    max_lag: int,
    eps: float = 0.05,
    weighting: str = "phat",
    s2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K5: gather by ``index_select``, then the
    K2 body. Same contract as :func:`gcc_pairs_onehot_lag_mags`.
    Through its wrapper on the CPU it runs at one intra-op thread
    (:func:`device.cpu_single_thread`, fault F2). The fault showed
    first here: with two threads, the first call of 3 in 96 fresh
    processes returned lag windows off by 2.6e-3 of their maximum."""
    gate = resolve_gate(weighting, s2 is not None)
    pi = torch.as_tensor(np.asarray(pair_i, np.int64), device=spec_re.device)
    pj = torch.as_tensor(np.asarray(pair_j, np.int64), device=spec_re.device)
    sel = lambda x, idx: x.index_select(-2, idx)
    return _whiten_invert_plain(
        sel(spec_re, pi), sel(spec_im, pi), sel(spec_re, pj), sel(spec_im, pj), s2, max_lag, eps, gate
    )


# -- K6: row-aligned pre-gathered pairs -----------------------------------


def gcc_rows_lag_mags(
    xre: torch.Tensor,
    xim: torch.Tensor,
    yre: torch.Tensor,
    yim: torch.Tensor,
    *,
    max_lag: int,
    eps: float = 0.05,
    weighting: str = "phat",
    s2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Lag windows for row-aligned pair spectra: row k of X with row k of Y.

    Args:
      xre/xim, yre/yim: float32 ``[P, nfft]`` CT-order spectra.
      weighting, s2: as :func:`gcc_pairs_onehot_lag_mags`, ``s2 [P]``.
    Returns:
      float32 ``[P, 2·max_lag+1]``.

    CPU tensors go through :func:`gcc_rows_lag_mags_plain`; CUDA tensors
    launch the kernel.
    """
    gate = resolve_gate(weighting, s2 is not None)
    if not (xre.shape == xim.shape == yre.shape == yim.shape) or xre.dim() != 2 or xre.shape[0] < 1:
        raise ValueError(f"need four [P ≥ 1, nfft] spectra, got {tuple(xre.shape)}, {tuple(xim.shape)}, "
                         f"{tuple(yre.shape)}, {tuple(yim.shape)}")
    p, nfft = xre.shape
    if s2 is not None and s2.shape != (p,):
        raise ValueError(f"s2 {tuple(s2.shape)} does not match [{p}]")
    s2 = s2 if gate == "l2rx" else None
    _check_float32(xre.device, xre=xre, xim=xim, yre=yre, yim=yim, **({} if s2 is None else {"s2": s2}))
    _check_lag(nfft, max_lag)
    if xre.device.type == "cpu":
        with device.cpu_single_thread():
            return gcc_rows_lag_mags_plain(
                xre, xim, yre, yim, max_lag=max_lag, eps=eps, weighting=weighting, s2=s2
            )
    if xre.device.type != "cuda":
        raise ValueError(f"no K6 implementation for device {xre.device}")
    return _launch_rows(xre, xim, yre, yim, s2, max_lag, eps, gate)


def _launch_rows(xre, xim, yre, yim, s2, max_lag, eps, gate):
    """K6: one pair a block, ``gcc_rows_kernel<n1>``."""
    global rows_launch_count
    p, n = xre.shape
    n1, n2, nneg, npos = _geometry(n, max_lag, "K6")
    _check_aligned("K6", xre=xre, xim=xim, yre=yre, yim=yim)
    plan = wide_plan(n1, n2, nneg, npos, 1)
    wi, w2, tw = _tables(n, n1, xre.device)
    out = torch.empty((p, 2 * max_lag + 1), dtype=torch.float32, device=xre.device)
    fn = build.kernel("rm_gcc_rows_lag_mags", _K6_ARGTYPES)
    err = fn(
        _ptr(xre), _ptr(xim), _ptr(yre), _ptr(yim), _ptr(s2),
        _ptr(wi), _ptr(w2), _ptr(tw), _ptr(out),
        p, n1, n2, nneg, npos, max_lag, plan.rows, plan.ntg, plan.groups, _GATE_CODE[gate],
        eps * eps, eps, 1.0 / n,
        _stream(xre),
    )
    build.check(err, "gcc_rows_lag_mags")
    rows_launch_count += 1
    return out


def gcc_rows_lag_mags_plain(
    xre: torch.Tensor,
    xim: torch.Tensor,
    yre: torch.Tensor,
    yim: torch.Tensor,
    *,
    max_lag: int,
    eps: float = 0.05,
    weighting: str = "phat",
    s2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of K6: the K2 body on row-aligned pairs. Same
    contract as :func:`gcc_rows_lag_mags`. Through its wrapper on the CPU it runs at one intra-op thread
    (:func:`device.cpu_single_thread`, fault F2)."""
    gate = resolve_gate(weighting, s2 is not None)
    return _whiten_invert_plain(xre, xim, yre, yim, s2 if gate == "l2rx" else None, max_lag, eps, gate)
