"""Kernel K7: forward natural-order FFT of rows.

Replaces ``radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows`` (body
``_fft_rows_kernel``; the ``fft``/``ifft`` wrappers are the conjugation
identity around it). Two CUDA designs, chosen by length alone
(:func:`design`); a length neither takes raises:

- ``"radix"`` (``csrc/fft_natural_radix.cu``), n = 2^m with 4096 ≤ n ≤
  16384, a row small enough for one SM: one launch, one block of n/16
  threads a row, each thread holding 16 complex points in registers. A
  Stockham (autosort) plan of radix-16 passes and a last radix-2 or
  radix-4 one (:func:`radix_plan`: 16384 = 16·16·16·4, 8192 = 16·16·16·2,
  4096 = 16·16·16): each pass twiddles, runs its 16-, 4- or 2-point FFT
  in a thread's registers, and hands its outputs to the next pass
  through one planar, XOR-swizzled shared-memory buffer (2·4·n bytes,
  128 KiB at 16384; at most two accesses a bank per warp). The row is
  read from device memory straight into registers and the last pass
  stores straight to natural bin order: 16 B of device traffic a point,
  no scratch. Twiddles are float32 tables of float64 roots of unity,
  rounded once. Bound: bytes, 16 B a point (0.641 ms at [8192, 16384]
  on an H100 SXM's 3.35 TB/s). Register form: n/16 threads × 16 points
  under a 64-register cap (1024 threads at 16384); ``-Xptxas -v`` on
  sm_90a reports 64 registers and no spills at 16384 and 4096, 8 bytes
  spilled at 8192 (on no path).
- ``"cluster"`` (``csrc/fft_natural_cluster.cu``), n = 32768 and 65536,
  a row past one block's 227 KB: one launch, a row on a thread-block
  cluster of c = n/16384 blocks (2, 4). Block r folds a radix-c
  decimation-in-frequency stage into its loads, y_r[j] = W_n^(r·j) ·
  Σ_s x[j + s·n/c]·W_c^(r·s) (:func:`cluster_plan`'s twiddles; each block
  reads its own n/c points, its partners' through distributed shared
  memory), runs the radix design's 16384-point passes on y_r with the
  last pass stored to its own shared memory, and after a cluster barrier
  writes natural bins [r·n/c, (r+1)·n/c) contiguously, gathering
  X[c·k + r'] = Y_{r'}[k] from the c blocks through distributed shared
  memory. 16 B of device traffic a point, no scratch; bound: bytes
  (1.282 ms at [8192, 32768] and [4096, 65536]).

The four-step split and tables are the reference's (``fft_kernel._split``,
``_constants``), copied here and held equal to it by a test: n = n1·n2
with n2 the largest divisor ≤ √n and n1 ≤ 256; x[j + n1·q] is viewed as
``[n2, n1]``; inner n2-point DFT over q, twiddle exp(−2πi·j·k2/n), outer
n1-point DFT over j; bin k = k2 + n2·k1. :func:`fft_rows_plain` runs it
(the CPU path and the card's comparison). The designs compute in FP32
on the CUDA cores; the TPU kernel runs its products as explicit bf16x3
(module precision HIGH), so FP32 is at least as precise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops.cuda import build

launch_count = 0  # calls that launched a CUDA kernel, either design (not the plain version)
design_counts = {"radix": 0, "cluster": 0}  # the same launches, by design

MAX_FACTOR = 256  # fft_kernel.MAX_FACTOR
RADIX_MIN_N = 4096  # the radix design's lengths: powers of two in [RADIX_MIN_N, RADIX_MAX_N]
RADIX_MAX_N = 16384  # a planar complex row of 128 KiB, one block's exchange buffer
POINTS = 16  # complex points a thread holds in the radix design (POINTS in fft_natural_radix.cu)
RADIX = 16  # the radix of every pass but the last
CLUSTER_SUB_N = RADIX_MAX_N  # a cluster block's sub-FFT (M in fft_natural_cluster.cu)
CLUSTER_N = (32_768, 65_536)  # the cluster design's lengths: c = n / CLUSTER_SUB_N blocks a row

_CLUSTER_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_CLUSTER_INFO_ARGTYPES = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
_RADIX_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def split(n: int) -> Tuple[int, int]:
    """(n1, n2) with n = n1·n2, n2 the largest divisor ≤ √n, n1 ≤ 256
    (``fft_kernel._split``). Raises ValueError when n1 > 256."""
    n2 = 1
    f = 1
    while f * f <= n:
        if n % f == 0:
            n2 = f
        f += 1
    n1 = n // n2
    if n1 > MAX_FACTOR:
        raise ValueError(
            f"FFT length {n} not supported by the fused kernel (needs n1={n1} ≤ {MAX_FACTOR})"
        )
    return n1, n2


def lane_aligned(n: int) -> bool:
    """The reference's routing condition (``fft_kernel.mosaic_compatible``):
    both factors of :func:`split` are multiples of 128. It is a Mosaic
    constraint of the TPU; the port keeps it so both packages route each
    length alike."""
    try:
        n1, n2 = split(n)
    except ValueError:
        return False
    return n1 % 128 == 0 and n2 % 128 == 0


def design(n: int) -> str:
    """The CUDA design that transforms rows of ``n`` points: ``"radix"``
    for a power of two in [``RADIX_MIN_N``, ``RADIX_MAX_N``], ``"cluster"``
    for 32768 and 65536 (:data:`CLUSTER_N`). Raises ValueError for any
    other length."""
    if RADIX_MIN_N <= n <= RADIX_MAX_N and n & (n - 1) == 0:
        return "radix"
    if n in CLUSTER_N:
        return "cluster"
    raise ValueError(
        f"K7 takes powers of two in [{RADIX_MIN_N}, {RADIX_MAX_N}] and {CLUSTER_N}; got {n}"
    )


class RadixPlan(NamedTuple):
    """The radix design's Stockham passes and twiddles for one length.

    Pass p has radix ``passes[p][0]`` and stride ``passes[p][1]`` (NS, the
    product of the earlier radices). Butterfly j < n/R of a pass takes
    inputs ``j + r·n/R`` (r < R), multiplies input r by
    ``W_{NS·R}^{r·(j mod NS)}``, runs the R-point FFT and writes output r
    to ``(j // NS)·NS·R + j mod NS + r·NS``; after the last pass that is
    bin order. Pass p's twiddles are ``twiddles[offsets[p]:][:(R−1)·NS]``
    as ``[R−1, NS]`` (row r−1, column j mod NS); the first pass (NS = 1)
    has none. The kernel computes the same offsets.
    """

    n: int
    points: int  # complex points a thread holds
    threads: int  # n // points, one block a row
    passes: Tuple[Tuple[int, int], ...]  # (radix, NS) per pass
    offsets: Tuple[int, ...]  # into twiddles, per pass
    twiddles: np.ndarray  # [Σ (R−1)·NS, 2] float32 (re, im) of float64 roots


@functools.lru_cache(maxsize=None)
def radix_plan(n: int) -> RadixPlan:
    if design(n) != "radix":
        raise ValueError(f"no radix plan for {n}")
    radices = []
    rest = n
    while rest > 1:
        radices.append(min(RADIX, rest))
        rest //= radices[-1]
    passes, offsets, tables = [], [], []
    ns, off = 1, 0
    for r in radices:
        passes.append((r, ns))
        offsets.append(off)
        if ns > 1:
            e = np.outer(np.arange(1, r), np.arange(ns))  # [R−1, NS]: r·k
            w = np.exp(-2j * np.pi * e / (ns * r))  # complex128, rounded once below
            tables.append(np.stack([w.real, w.imag], axis=-1).reshape(-1, 2).astype(np.float32))
            off += (r - 1) * ns
        ns *= r
    return RadixPlan(n, POINTS, n // POINTS, tuple(passes), tuple(offsets), np.concatenate(tables))


@functools.lru_cache(maxsize=8)
def device_radix_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """:func:`radix_plan`'s twiddles on ``device``, ``[T, 2]`` float32."""
    return torch.from_numpy(radix_plan(n).twiddles).to(device)


class ClusterPlan(NamedTuple):
    """The cluster design's split of one length: c blocks a row, each a
    sub-FFT of m = n/c points (:func:`radix_plan` of m) after the radix-c
    DIF stage. ``pre[(r − 1)·m + j]`` is W_n^(r·j) for r = 1..c−1, j < m,
    float32 (re, im) of float64 roots rounded once."""

    n: int
    c: int
    m: int
    pre: np.ndarray  # [(c − 1)·m, 2] float32


@functools.lru_cache(maxsize=None)
def cluster_plan(n: int) -> ClusterPlan:
    if design(n) != "cluster":
        raise ValueError(f"no cluster plan for {n}")
    c, m = n // CLUSTER_SUB_N, CLUSTER_SUB_N
    e = np.outer(np.arange(1, c), np.arange(m))  # [c − 1, m]: r·j
    w = np.exp(-2j * np.pi * e / n)  # complex128, rounded once below
    pre = np.stack([w.real, w.imag], axis=-1).reshape(-1, 2).astype(np.float32)
    return ClusterPlan(n, c, m, pre)


@functools.lru_cache(maxsize=8)
def device_cluster_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """:func:`cluster_plan`'s ``pre`` on ``device``, ``[(c − 1)·m, 2]`` float32."""
    return torch.from_numpy(cluster_plan(n).pre).to(device)


@functools.lru_cache(maxsize=None)
def constants(n: int):
    """``(n1, n2, w1re, w1im, w2re, w2im, twre, twim)`` float32 tables
    (``fft_kernel._constants``): ``w1`` the n1-point DFT matrix, ``w2`` the
    n2-point one, ``tw[k2, j] = exp(−2πi·k2·j/n)``."""
    n1, n2 = split(n)
    w1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)  # [k2, n1]
    f32 = lambda a: a.astype(np.float32)
    return (
        n1,
        n2,
        f32(w1.real), f32(w1.imag),
        f32(w2.real), f32(w2.imag),
        f32(tw.real), f32(tw.imag),
    )


class Tables(NamedTuple):
    """:func:`constants` on a device (planar float32), the plain version's."""

    w1re: torch.Tensor  # [n1, n1]
    w1im: torch.Tensor
    w2re: torch.Tensor  # [n2, n2]
    w2im: torch.Tensor
    twre: torch.Tensor  # [n2, n1]
    twim: torch.Tensor


@functools.lru_cache(maxsize=8)
def device_tables(n: int, device: torch.device) -> Tables:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Tables(*(t(a) for a in constants(n)[2:]))


def _check(re: torch.Tensor, im: torch.Tensor) -> None:
    if re.shape != im.shape or re.dim() < 1 or re.numel() == 0:
        raise ValueError(f"need re/im of one non-empty shape [..., n], got {tuple(re.shape)}, {tuple(im.shape)}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"need float32, got {re.dtype}, {im.dtype}")
    if re.device != im.device:
        raise ValueError(f"re on {re.device}, im on {im.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("re/im must be contiguous")
    split(re.shape[-1])


def fft_rows(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward FFT over the last axis, natural bin order.

    Args:
      re/im: float32 contiguous ``[..., n]`` with a :func:`split`.
    Returns:
      ``(fr, fi)`` of the same shape, bin k at index k.

    CPU tensors go through :func:`fft_rows_plain`; CUDA tensors launch the
    kernel of :func:`design`, which raises for a length neither design
    takes.
    """
    _check(re, im)
    if re.device.type == "cpu":
        with device.cpu_single_thread():
            return fft_rows_plain(re, im)
    if re.device.type != "cuda":
        raise ValueError(f"no K7 implementation for device {re.device}")
    kind = design(re.shape[-1])
    out = _launch_radix(re, im) if kind == "radix" else _launch_cluster(re, im)
    global launch_count
    launch_count += 1
    design_counts[kind] += 1
    return out


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _launch_radix(re, im):
    n = re.shape[-1]
    fn = build.kernel("rm_fft_natural_radix", _RADIX_ARGTYPES)
    tw = device_radix_twiddles(n, re.device)
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    err = fn(_ptr(re), _ptr(im), _ptr(tw), _ptr(fr), _ptr(fi), re.numel() // n, n, _stream(re))
    build.check(err, "fft_rows (radix)")
    return fr, fi


def _launch_cluster(re, im):
    n = re.shape[-1]
    fn = build.kernel("rm_fft_natural_cluster", _CLUSTER_ARGTYPES)
    tw = device_radix_twiddles(CLUSTER_SUB_N, re.device)
    pre = device_cluster_twiddles(n, re.device)
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    err = fn(_ptr(re), _ptr(im), _ptr(tw), _ptr(pre), _ptr(fr), _ptr(fi), re.numel() // n, n, _stream(re))
    build.check(err, "fft_rows (cluster)")
    return fr, fi


def cluster_info(n: int) -> dict:
    """The cluster design's shape at n on the current card: ``c``, shared
    memory a block (``smem``) and ``cudaOccupancyMaxActiveClusters``
    (``clusters``; 0 would mean the card cannot run it)."""
    design(n)
    c, smem, clusters = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    fn = build.kernel("rm_fft_natural_cluster_info", _CLUSTER_INFO_ARGTYPES)
    err = fn(n, ctypes.byref(c), ctypes.byref(smem), ctypes.byref(clusters))
    build.check(err, "fft_natural cluster_info")
    return {"c": c.value, "smem": smem.value, "clusters": clusters.value}


def fft_rows_plain(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7: the reference kernel's four-step on the
    same tables, as batched matrix products. Same contract as
    :func:`fft_rows`. On the card it is the comparison only, with
    ``torch.backends.cuda.matmul.allow_tf32 = False`` set by the caller.
    Through its wrapper on the CPU it runs at one intra-op thread
    (:func:`device.cpu_single_thread`, fault F2)."""
    shape = re.shape
    n = shape[-1]
    n1, n2 = split(n)
    t = device_tables(n, re.device)
    xr = re.reshape(-1, n2, n1)  # x[r, q, j] at time j + n1·q
    xi = im.reshape(-1, n2, n1)
    # inner DFT over q: B[r, k2, j] = Σ_q W2[k2, q] x[r, q, j]
    br = t.w2re @ xr - t.w2im @ xi
    bi = t.w2re @ xi + t.w2im @ xr
    # twiddle exp(−2πi·k2·j/n)
    cr = br * t.twre - bi * t.twim
    ci = br * t.twim + bi * t.twre
    # outer DFT over j: D[r, k2, k1] = Σ_j C[r, k2, j] W1[j, k1]
    dr = cr @ t.w1re - ci @ t.w1im
    di = cr @ t.w1im + ci @ t.w1re
    # bin k = k2 + n2·k1 sits at [k1, k2]
    return dr.transpose(-1, -2).reshape(shape), di.transpose(-1, -2).reshape(shape)
