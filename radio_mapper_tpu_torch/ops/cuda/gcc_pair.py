"""Kernels K2, K5 and K6: whitening × inverse DFT × lag window.

Three entries into two CUDA bodies (``radio_mapper_tpu_torch/csrc/gcc_pair.cu``
around ``csrc/gcc_pair.cuh``, which kernel K8 shares, for n1 = 128 and
256, and ``csrc/gcc_pair_wide.cuh`` for n1 = 384, 640, 896), each with its
plain PyTorch version and its own launch counter:

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

Design, n1 = 128 and 256 (``csrc/gcc_pair.cuh``, shared with kernel K8):
one thread block per pair. It reads X_i and Y_j by index straight from
the CT-order spectra (the TPU's resident spectra and one-hot matmul
gather are a VMEM/MXU layout device with no use here; one subchannel's 64
spectra, 2.6 MB, stay in the 50 MB L2) and runs the four-step inverse in
chunks of CT rows. Each warp takes whole rows k2: its lanes load the
row's n1 bins (coalesced), form and whiten R = X·conj(Y) in registers,
run the inner n1-point inverse FFT (a P = n1/32-point radix-2 transform
in registers, then five radix-2 stages across lanes by
``__shfl_xor_sync``) and store it times the inverse twiddle to shared
memory. The block then folds the chunk into the outer inverse DFT over
k2, accumulated ONLY into the lag-window time rows (``ceil(L/n1)`` tail
rows and ``L//n1 + 1`` head rows), in k2 order whatever the chunk size
(:func:`chunk_rows`: 256/n1 rows a warp). Shared memory holds one chunk
and the window accumulators (≈ 26 KB at nfft 17408 / max_lag 512, ≈ 19
KB at nfft 5120 / max_lag 128), so several blocks share an SM. FP32 on
the CUDA cores; ``tests/test_torch_pair_fft.py`` replays the schedule in
numpy.

Design, n1 = 384, 640 and 896 (``csrc/gcc_pair_wide.cuh``, one kernel
instantiated for each length): K2 takes tiles of two pairs of a channel
that share a receiver (:func:`wide_tiles`), K5 and K6 one pair; the
tile's CT rows arrive by bulk copies (``cp.async.bulk`` completing on an
mbarrier) into a double buffer in shared memory, a chunk of
:func:`wide_plan`'s rows ahead; one warp a (pair, row) runs the
mixed-radix warp FFT (two radix-2 stages, direct q-point DFTs, q = 3, 5,
7, then the lane stages) and stores C = E·TW, TW formed from two small
tables (:func:`wide_twiddle_factors`); the window rows are folded on the
tensor cores, ``mma.sync.m16n8k8`` TF32 in the 3xTF32 split with FP32
accumulators in registers, the block's rows of W2 staged once in shared
memory; the window's n-tiles past two a pair go to more blocks along
``blockIdx.y``. :func:`wide_info` reads each kernel's registers, local
memory and resident blocks on the card.
``tests/test_torch_pair_wide.py`` and ``tests/test_torch_mixed_radix.py``
replay it in numpy.

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
the largest part of the work; each pair reads two spectra (one and a
half in K2's wide tiles), mostly L2 hits since a channel's B spectra are
shared by all its pairs. Left for later PRs: fusing the forward
transform into this kernel so spectra stay on chip (kernel K8 does the
latter through a scratch at n1 = 128).
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

launch_count = 0  # K2 launches (not of the plain version)
onehot_launch_count = 0  # K5 launches
rows_launch_count = 0  # K6 launches

THREADS = 256  # must match K2_THREADS in gcc_pair.cu and rm_wide::THREADS
RJ = 8  # must match rm_pair::RJ in gcc_pair.cuh: (THREADS // n1) * RJ chunk rows for n1 ≤ 256
PAIR_N1 = ct_plan.RADIX_N1  # the inner lengths of the pair body's warp FFT
WIDE_N1 = (384, 640, 896)  # gcc_pair_wide.cuh's lengths (rm_wide::wide_n1); 128, 256: gcc_pair.cuh
WIDE_SLOTS = 2  # rm_wide::SLOTS: accumulator (pair, n-tile) slots a warp
WIDE_TW_LO = 256  # rm_wide::TW_LO: W_n^e = W_n^(256·(e // 256))·W_n^(e % 256)
WIDE_KINDS = {"K2": 0, "K5": 1, "K6": 2}  # rm_gcc_pair_wide_info's kind
SMEM_LIMIT = 232_448  # H100 per-block shared memory
WIDE_STATIC_SMEM = 1024  # room left for the wide kernels' static shared memory (the tile, barriers)

_ARGTYPES = (
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 9
    + [ctypes.c_float] * 3
    + [ctypes.c_void_p]
)
_ROWS_ARGTYPES = (
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 7
    + [ctypes.c_float] * 3
    + [ctypes.c_void_p]
)
_WIDE_K2_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
_WIDE_K5_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
_WIDE_K6_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
_WIDE_INFO_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]

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


def chunk_rows(threads: int, n1: int) -> int:
    """CT rows a chunk of the n1 = 128/256 pair body holds
    (``rm_pair::chunk_rows``): ``(threads // n1)·RJ``. Above 256 (one row
    a warp) it is the chunk ``tests/test_torch_pair_fft.py`` replays that
    body's fold with; the kernels run the wide body there."""
    return (threads // n1) * RJ if n1 <= RJ * 32 else threads // 32


def smem_bytes(n1: int, nneg: int, npos: int, threads: int = THREADS) -> int:
    """Dynamic shared memory of the pair body for a block of ``threads``
    at n1 = 128, 256 (``rm_pair::pair_smem_bytes``): a chunk of
    :func:`chunk_rows` CT rows and the ``nneg + npos`` window rows, n1
    complex floats each. The wide lengths' is :func:`wide_plan`'s."""
    if n1 in WIDE_N1:
        raise ValueError(f"n1 {n1} runs the wide pair body: see wide_plan")
    return (chunk_rows(threads, n1) + nneg + npos) * n1 * 8


class WidePlan(NamedTuple):
    """A wide launch (``csrc/gcc_pair_wide.cuh``): ``pairs`` a block,
    ``nsrc`` staged sources, ``rows`` CT rows a chunk, ``ntg`` n-tiles a
    pair a block, ``groups`` blocks along ``blockIdx.y``, ``smem`` bytes of
    dynamic shared memory."""

    pairs: int
    nsrc: int
    rows: int
    ntg: int
    groups: int
    smem: int


def wide_smem_bytes(n1: int, n2: int, nsrc: int, rows: int, ntg: int) -> int:
    """``rm_wide::smem_floats`` in bytes: two buffers of ``nsrc`` sources ×
    2 planes × ``rows`` rows of n1 floats; the block's ``ntg``·4
    window rows of W2 (n2 complex floats each); the warp
    FFT's twiddle table ([P − 1][32] + q complex floats); the inverse
    twiddle's factors (ceil(n/256) + 256 complex floats)."""
    p = n1 // 32
    return 4 * (2 * nsrc * 2 * rows * n1 + 2 * ntg * 4 * n2 + 2 * ((p - 1) * 32 + p // 4)
                + 2 * (-(-n1 * n2 // WIDE_TW_LO) + WIDE_TW_LO))


def wide_plan(n1: int, n2: int, nneg: int, npos: int, pairs: int) -> WidePlan:
    """How a wide kernel covers a window of ``nneg + npos`` rows: tiles of
    ``pairs`` pairs (K2: 2 sharing a receiver; K5, K6: 1) while the window
    fits one 8-column n-tile (max_lag < 2·n1 or so), else one pair a block
    with its n-tiles two a block; 8 rows a chunk for one pair, 4 for two,
    4 where 8 do not fit shared memory."""
    if n1 not in WIDE_N1:
        raise ValueError(f"the wide pair body takes n1 in {WIDE_N1}, not {n1}")
    nt = -(-(nneg + npos) // 4)  # 8 columns: 4 window rows, re and im
    g = pairs if pairs * nt <= WIDE_SLOTS else 1
    ntg = min(nt, WIDE_SLOTS // g)
    rows = 8 // g
    if wide_smem_bytes(n1, n2, g + 1, rows, ntg) > SMEM_LIMIT - WIDE_STATIC_SMEM:
        rows = 4
    smem = wide_smem_bytes(n1, n2, g + 1, rows, ntg)
    if smem > SMEM_LIMIT - WIDE_STATIC_SMEM:
        raise ValueError(f"the wide pair body at {n1}·{n2} needs {smem} B of shared memory")
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
    """K2's tiles (``gcc_pair_wide_kernel``): int32 ``[T, 8]``, each
    (slot-0 receiver, slot-1, slot-2 or −1, pairs in the tile, then per
    pair its index and 1 where its X is the leaf). With ``pairs = 2`` each
    receiver r in turn takes its pairs not yet in a tile, in list order,
    two at a time: a tile of two shares r (slot 0), each pair's other
    receiver is its leaf. What is left (and every pair, with ``pairs =
    1``) is a tile of one. For all 28 pairs of 8 receivers: 14 tiles of
    two, every receiver the centre of at least one."""
    pi, pj = (np.asarray(a, np.int64) for a in (pair_i, pair_j))
    tiles, used = [], np.zeros(pi.size, bool)
    if pairs == 2:
        for r in range(int(max(pi.max(), pj.max())) + 1):
            mine = [k for k in range(pi.size) if not used[k] and r in (pi[k], pj[k])]
            for a, b in zip(mine[0::2], mine[1::2]):
                leaf = lambda k: int(pj[k] if pi[k] == r else pi[k])
                tiles.append([r, leaf(a), leaf(b), 2, a, int(pi[a] != r), b, int(pi[b] != r)])
                used[a] = used[b] = True
    tiles += [[int(pi[k]), int(pj[k]), -1, 1, k, 0, 0, 0] for k in np.flatnonzero(~used)]
    return np.asarray(tiles, np.int32).reshape(-1, 8)


@functools.lru_cache(maxsize=16)
def _tile_tensor(pair_i: bytes, pair_j: bytes, pairs: int, device: torch.device) -> torch.Tensor:
    to = lambda b: np.frombuffer(b, dtype=np.int32)
    return torch.from_numpy(wide_tiles(to(pair_i), to(pair_j), pairs)).to(device)


def device_tiles(pair_i, pair_j, pairs: int, device: torch.device) -> torch.Tensor:
    """:func:`wide_tiles` on ``device``, cached by the lists' bytes."""
    key = lambda p: np.ascontiguousarray(p, dtype=np.int32).tobytes()
    return _tile_tensor(key(pair_i), key(pair_j), pairs, device)


def wide_info(kind: str, n1: int, smem: int) -> dict:
    """What the card makes of a wide kernel (``rm_gcc_pair_wide_info``):
    registers a thread, local memory a thread in bytes (0: no spills),
    blocks resident on an SM at ``smem`` bytes of dynamic shared memory,
    static shared memory in bytes."""
    fn = build.kernel("rm_gcc_pair_wide_info", _WIDE_INFO_ARGTYPES)
    info = (ctypes.c_int * 4)()
    build.check(fn(WIDE_KINDS[kind], n1, smem, ctypes.cast(info, ctypes.c_void_p)), f"wide info {kind} n1 {n1}")
    return dict(zip(("registers", "local_bytes", "blocks", "static_smem"), info))


def _geometry(n: int, max_lag: int, what: str):
    """``(n1, n2, nneg, npos)`` for a kernel launch; raises where the
    inner length or shared memory does not fit (the wide lengths' shared
    memory does not grow with the window)."""
    n1, n2 = ct_plan.ct_split(n)
    if n1 not in PAIR_N1:
        raise ValueError(f"{what} supports n1 in {PAIR_N1}; nfft {n} = {n1}·{n2}")
    nneg, npos = window_rows(n, max_lag)
    if n1 in WIDE_N1:
        wide_plan(n1, n2, nneg, npos, 1)  # raises where even one pair a block does not fit
    else:
        smem = smem_bytes(n1, nneg, npos)
        if smem > SMEM_LIMIT:
            raise ValueError(f"max_lag {max_lag} needs {smem} B of shared memory (limit {SMEM_LIMIT})")
    return n1, n2, nneg, npos


def _check_aligned(what: str, **tensors) -> None:
    """The wide body's bulk copies read 16-byte aligned rows."""
    for name, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")


def _tables(n: int, n1: int, device: torch.device):
    """The kernel's ``(wi, w2, tw)``: the inverse radix table of the warp
    FFT and the inverse four-step's outer DFT and twiddle."""
    t = ct_plan.device_tables(n, True, device)
    return ct_plan.device_inverse_radix_table(n1, device), t.w2, t.tw


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
    global launch_count
    out = launch_k2(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate)
    launch_count += 1
    return out


def launch_k2(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate):
    """K2's kernel on checked CUDA spectra under an explicit ``gate``,
    counted by the caller: K2 as one launch of K2, kernel K8's long rows as
    part of one launch of K8."""
    c, b, n = spec_re.shape
    n1, n2, nneg, npos = _geometry(n, max_lag, "K2")
    if n1 in WIDE_N1:
        return _launch_k2_wide(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate,
                               n1, n2, nneg, npos)
    fn = build.kernel("rm_gcc_pair_lag_mags", _ARGTYPES)
    wi, w2, tw = _tables(n, n1, spec_re.device)
    pi, pj = device_pairs(pair_i, pair_j, spec_re.device)
    p = pi.shape[0]
    out = torch.empty((c, p, 2 * max_lag + 1), dtype=torch.float32, device=spec_re.device)
    err = fn(
        _ptr(spec_re), _ptr(spec_im), _ptr(row_smax), _ptr(pi), _ptr(pj),
        _ptr(wi), _ptr(w2), _ptr(tw), _ptr(out),
        c, b, p, n1, n2, nneg, npos, max_lag, _GATE_CODE[gate],
        eps * eps, eps, 1.0 / n,
        _stream(spec_re),
    )
    build.check(err, "gcc_pair_lag_mags")
    return out


def _launch_k2_wide(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps, gate, n1, n2, nneg, npos):
    """K2 at n1 = 384, 640, 896: tiles of two pairs that share a receiver
    (:func:`wide_tiles`), ``gcc_pair_wide_kernel<n1>``."""
    c, b, n = spec_re.shape
    _check_aligned("K2", spec_re=spec_re, spec_im=spec_im)
    plan = wide_plan(n1, n2, nneg, npos, 2)
    fn = build.kernel("rm_gcc_pair_wide_lag_mags", _WIDE_K2_ARGTYPES)
    wi, w2, _ = _tables(n, n1, spec_re.device)
    tw = device_twiddle_factors(n, spec_re.device)
    tiles = device_tiles(pair_i, pair_j, plan.pairs, spec_re.device)
    p = len(pair_i)
    out = torch.empty((c, p, 2 * max_lag + 1), dtype=torch.float32, device=spec_re.device)
    err = fn(
        _ptr(spec_re), _ptr(spec_im), _ptr(row_smax), _ptr(tiles),
        _ptr(wi), _ptr(w2), _ptr(tw), _ptr(out),
        c, b, p, tiles.shape[0], n1, n2, nneg, npos, max_lag,
        plan.nsrc, plan.rows, plan.ntg, plan.groups, _GATE_CODE[gate],
        eps * eps, eps, 1.0 / n,
        _stream(spec_re),
    )
    build.check(err, "gcc_pair_lag_mags (wide)")
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
    global onehot_launch_count
    *lead, b, n = spec_re.shape
    c = spec_re.numel() // (b * n)
    n1, n2, nneg, npos = _geometry(n, max_lag, "K5")
    wi, w2, tw = _tables(n, n1, spec_re.device)  # the wide body takes W_n's factors for tw
    pi, pj = device_pairs(pair_i, pair_j, spec_re.device)
    p = pi.shape[0]
    out = torch.empty((*lead, p, 2 * max_lag + 1), dtype=torch.float32, device=spec_re.device)
    if n1 in WIDE_N1:  # gcc_pairs_onehot_wide_kernel<n1>, one pair a block
        _check_aligned("K5", spec_re=spec_re, spec_im=spec_im)
        plan = wide_plan(n1, n2, nneg, npos, 1)
        tw = device_twiddle_factors(n, spec_re.device)
        fn = build.kernel("rm_gcc_pairs_onehot_wide_lag_mags", _WIDE_K5_ARGTYPES)
        wide = (plan.rows, plan.ntg, plan.groups)
    else:
        fn = build.kernel("rm_gcc_pairs_onehot_lag_mags", _ARGTYPES)
        wide = ()
    err = fn(
        _ptr(spec_re), _ptr(spec_im), _ptr(s2), _ptr(pi), _ptr(pj),
        _ptr(wi), _ptr(w2), _ptr(tw), _ptr(out),
        c, b, p, n1, n2, nneg, npos, max_lag, *wide, _GATE_CODE[gate],
        eps * eps, eps, 1.0 / n,
        _stream(spec_re),
    )
    build.check(err, "gcc_pairs_onehot_lag_mags")
    onehot_launch_count += 1
    return out


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
    global rows_launch_count
    p, n = xre.shape
    n1, n2, nneg, npos = _geometry(n, max_lag, "K6")
    wi, w2, tw = _tables(n, n1, xre.device)  # the wide body takes W_n's factors for tw
    out = torch.empty((p, 2 * max_lag + 1), dtype=torch.float32, device=xre.device)
    if n1 in WIDE_N1:  # gcc_rows_wide_kernel<n1>, one pair a block
        _check_aligned("K6", xre=xre, xim=xim, yre=yre, yim=yim)
        plan = wide_plan(n1, n2, nneg, npos, 1)
        tw = device_twiddle_factors(n, xre.device)
        fn = build.kernel("rm_gcc_rows_wide_lag_mags", _WIDE_K6_ARGTYPES)
        wide = (plan.rows, plan.ntg, plan.groups)
    else:
        fn = build.kernel("rm_gcc_rows_lag_mags", _ROWS_ARGTYPES)
        wide = ()
    err = fn(
        _ptr(xre), _ptr(xim), _ptr(yre), _ptr(yim), _ptr(s2),
        _ptr(wi), _ptr(w2), _ptr(tw), _ptr(out),
        p, n1, n2, nneg, npos, max_lag, *wide, _GATE_CODE[gate],
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
