"""Kernel K3: forward CT-order FFT of rows.

Replaces ``radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows_ct`` (body
``fft_kernel.ct_fft_core``). The CUDA source is
``radio_mapper_tpu_torch/csrc/fft_rows_ct.cu``; its steps are
``csrc/ct_fft.cuh``.

Two designs, chosen by length inside :func:`fft_rows_ct`
(:func:`geometry`); a length neither takes raises ``ValueError``.

One block a row, n = 128·n2 ≤ :data:`MAX_N` (``csrc/fft_rows_ct.cu``):
one 512-thread block keeps the row (re+im, 40,960 B at the wideband nfft
5120) in shared memory. The length splits as n2 = a·r, a = min(8,
2^v₂(n2)) (:func:`ct_plan.radix_split`): step A runs an a-point radix-2
FFT in registers; step B the direct r-point DFT with the row twiddle
folded into its write (its r ≤ 24 inputs in registers, as on every
length the pipelines plan up to 24576; streamed from shared memory above
that); step C one warp per 128-point row, a radix-2 FFT across lanes with
``__shfl_xor_sync`` that stores the spectra, coalesced, in CT order. All
twiddles are float32 tables of float64 roots of unity
(:func:`ct_plan.radix_tables`, ``ct_constants``' twiddle).

Long rows, n > :data:`MAX_N` with n1 ∈ :data:`ct_plan.RADIX_N1` (128,
256, 384, 640, 896) and 8 | n2 (:func:`fft_rows_ct_long`,
:func:`long_geometry`), two designs by n1:

- n1 = 128 or 256, the cluster design (``csrc/fft_rows_ct_cluster.cu``):
  a row is a thread-block cluster of c = 2, 4 or 8 blocks
  (:func:`cluster_size`: the least c for which two blocks fit an SM,
  33792 and 34816: 4, 66560: 8). Block ``rank`` owns n1/c columns as
  tiles of 32 (or 16) columns and runs steps A and B on them in place,
  then, after a cluster barrier, step C on n2/c slot rows, each lane
  gathering its P = n1/32 points from the owning blocks through
  distributed shared memory, and stores in CT order. One pass through
  device memory, 16 B a sample.
- n1 = 384, 640 or 896, the wide design (``csrc/fft_detect_cluster.cuh``,
  kernel K1's one-pass kernel with its detect half off, a template on n1;
  :func:`wide_launch`): a cluster of 8 blocks of 512 threads, n1/8 = 48,
  80 or 112 columns a block, step C's mixed-radix P = 12, 20 or 28 in a
  register layout that runs two of its five lane stages in registers. At
  n1 = 384 at most 64 registers a thread, so two blocks an SM up to nfft
  70656; at 640 and 896 up to 128, one block an SM, but for K3 at 640
  where two fit by shared memory (up to 102400; the kernel picks its
  launch bounds, :func:`wide_info` reports them).
  One pass, 16 B a sample.

The workspace design (``csrc/fft_rows_ct_long.cu``: a column pass and a
row pass through a [rows, n] float2 workspace, 32 B a sample) stays built
at n1 = 384, 640 and 896 as the card tests' and
``tools/forward_times.py``'s comparison only (:func:`workspace_rows`); no
route reaches it.

Both give the one-block design's spectra bit for bit where it takes the
length too (the same per-value arithmetic). Every planned length up to
131072 has such a split.

What bounds it on the H100: device-memory bytes — a row read and its
spectrum written once, 80 KB a row at 5120 — and then the three block barriers
between a row's loads and its stores; the arithmetic is n1·a·r² complex
FMAs a row for step B plus the radix-2 butterflies (the direct four-step
DFT it replaced issued n·(n1 + n2) from shared memory).
Kernels K1 and K8 run the same steps (``ct_fft.cuh`` ``fft_power_row``)
and store the same spectra. The wideband path launches it once per block
on all M·B = 1024 rows; the two-kernel flagship route on 1024 rows of
17408; the single-dwell step's long rows (block_len 32768: 33792) run
the long design.
Left for later PRs: TMA row loads, tensor cores.

Precision: the reference's module default (``precision=None``) runs the
products as explicit bf16x3; the PHAT chain passes ``"default"``, which
is plain float32 on the CPU. The kernel and its plain version run
float32 (the caller disables TF32 for the plain version's products).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build

launch_count = 0  # launches of the CUDA kernel (not of the plain version)
design_counts = {"block": 0, "long": 0, "wide": 0}  # the same launches, by design ("long": the cluster design)

MAX_N = 24_576  # the one-block design's limit: one row in a block's shared memory (as kernel K1's)
WORKSPACE_MAX_ROWS = 65_535  # rows the workspace design takes (its column pass's grid rows)
SMEM_LIMIT = 232_448  # bytes of shared memory one block can have (227 KB)
SM_SMEM = 233_472  # bytes of shared memory an SM has for its blocks (228 KB)
SMEM_RESERVED = 1_024  # bytes the runtime reserves a block
CLUSTER_SIZES = (2, 4, 8)  # blocks a row in the cluster design; 8 is the portable cluster limit
CLUSTER_N1 = (128, 256)  # the cluster design's n1
CLUSTER_DETECT_STATIC_BYTES = 512  # K1's cluster kernel: its static shared memory (reductions, the floor's), at most
WIDE_N1 = (384, 640, 896)  # the wide design's n1 (fft_detect_cluster.cuh's instantiations)
WIDE_C = 8  # blocks a row in the wide design: block 0 holds the CT rows k2 = 0 mod 8
WIDE_THREADS = 512  # its block (fft_detect_cluster.cuh THREADS)
WIDE_STATIC_BYTES = 256  # its static shared memory (reduction scratch), at most

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_CLUSTER_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_INFO_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)] * 2
_WORKSPACE_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_WIDE_ARGTYPES = (
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p]
)
_WIDE_INFO_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 6


def _check(re: torch.Tensor, im: torch.Tensor) -> None:
    if re.shape != im.shape or re.dim() < 1 or re.numel() == 0:
        raise ValueError(f"need re/im of one non-empty shape [..., nfft], got {tuple(re.shape)}, {tuple(im.shape)}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"need float32, got {re.dtype}, {im.dtype}")
    if re.device != im.device:
        raise ValueError(f"re on {re.device}, im on {im.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("re/im must be contiguous")
    ct_plan.ct_split(re.shape[-1])


def fft_rows_ct(re: torch.Tensor, im: torch.Tensor):
    """Forward FFT over the last axis, bins in CT order.

    Args:
      re/im: float32 ``[..., nfft]`` time rows (already zero-padded), nfft
        with a CT split (:func:`ct_plan.ct_split`).
    Returns:
      ``(fr, fi)`` of the same shape: ``fr[..., m] + i·fi[..., m]`` is
      DFT bin ``k2 + n2·k1`` at ``m = k2·n1 + k1``.

    CPU tensors go through :func:`fft_rows_ct_plain`; CUDA tensors launch
    the design :func:`geometry` picks for nfft: one block a row up to
    :data:`MAX_N`, the long-row design above.
    """
    _check(re, im)
    if re.device.type == "cpu":
        with device.cpu_single_thread():
            return fft_rows_ct_plain(re, im)
    if re.device.type != "cuda":
        raise ValueError(f"no K3 implementation for device {re.device}")
    if geometry(re.shape[-1]) == "long":
        return fft_rows_ct_long(re, im)
    return _launch(re, im)


def geometry(n: int) -> str:
    """K3's design for rows of n samples, decided without a card:
    ``"block"`` (n = 128·n2 ≤ :data:`MAX_N`) or ``"long"`` (n > MAX_N,
    :func:`long_geometry`). Raises ValueError for a length without a CT
    split or that neither design takes."""
    n1, n2 = ct_plan.ct_split(n)
    if n1 == 128 and n <= MAX_N:
        return "block"
    if n > MAX_N:
        long_geometry(n)
        return "long"
    raise ValueError(f"K3 takes nfft ≤ {MAX_N} only as 128·n2; nfft {n} = {n1}·{n2}")


class LongGeometry(NamedTuple):
    """The long-row design's shape for one length (:func:`long_geometry`)."""

    n1: int
    n2: int
    a: int  # step A's length, 8
    r: int  # step B's length, n2 / 8
    design: str  # "cluster" (n1 = 128, 256) or "wide" (384, 640, 896)
    c: int  # blocks a row (the cluster)
    cols: int  # columns a tile: 32 where n2 ≤ 512 and 32 | n1/c, else 16; the wide design's n1/8


def cluster_smem(n1: int, n2: int, c: int, detect: bool = False) -> int:
    """Dynamic shared memory of one cluster block: its n1/c columns and
    W_128; with kernel K1's detect half (``fft_detect.cluster_detect``)
    also the power of its n2/c slot rows (4 bytes a value)."""
    return (n1 // c * n2 + 64) * 8 + (n2 // c * n1 * 4 if detect else 0)


def cluster_size(n1: int, n2: int, detect: bool = False) -> int:
    """The cluster design's blocks a row: the least c of
    :data:`CLUSTER_SIZES` for which two blocks fit one SM's shared memory
    (two 512-thread blocks an SM hide each other's latency), else the
    least for which one block does; ``detect``: kernel K1's, its power
    buffer and static shared memory (:data:`CLUSTER_DETECT_STATIC_BYTES`)
    in the fit."""
    static = CLUSTER_DETECT_STATIC_BYTES if detect else 0
    for fit in (lambda c: 2 * (cluster_smem(n1, n2, c, detect) + static + SMEM_RESERVED) <= SM_SMEM,
                lambda c: cluster_smem(n1, n2, c, detect) + static <= SMEM_LIMIT):
        c = next((c for c in CLUSTER_SIZES if (n1 // c) % 16 == 0 and fit(c)), None)
        if c is not None:
            return c
    raise ValueError(f"{n1}·{n2} does not fit a cluster of {CLUSTER_SIZES[-1]} blocks")


def wide_table_bytes(n1: int) -> int:
    """The wide design's tables in shared memory: W_n1^e (e < n1/2) and
    step C's stage twiddles, 126·q entries for n1 = 128·q (4,560, 7,600
    and 10,640 B at 384, 640, 896)."""
    return (n1 // 2 + 126 * (n1 // 128)) * 8


def wide_max_r(n1: int) -> int:
    """The largest r whose step-B column block (⌈r/4⌉ output quads × n1/32
    column groups) fits one round, an item a thread: 168, 100, 72."""
    return 4 * (WIDE_THREADS // (n1 // 32))


def wide_smem(n1: int, n2: int, detect: bool) -> int:
    """Dynamic shared memory of one wide-design block: its n1/8 columns (n
    bytes of float2); with the detect half the power of its n2/8 CT rows
    (n/2 bytes), which holds step B's table (W_r with rows padded to a
    multiple of 4) until step C, else that table; then the tables
    (:func:`wide_table_bytes`)."""
    n, r = n1 * n2, n2 // 8
    ab = r * 4 * (-(-r // 4)) * 8
    return n + (n // 2 if detect else ab) + wide_table_bytes(n1)


def wide_blocks(n1: int, n2: int, detect: bool) -> int:
    """Wide-design blocks one SM's shared memory holds: two or one. The
    card holds that many where the instantiation's launch bounds allow it
    (``min_blocks`` of :func:`wide_info`, which ``fft_detect_cluster.cuh``
    ``kernel_at`` alone picks), else one."""
    return 2 if 2 * (wide_smem(n1, n2, detect) + WIDE_STATIC_BYTES + SMEM_RESERVED) <= SM_SMEM else 1


def long_geometry(n: int) -> LongGeometry:
    """The long-row design's shape for rows of n samples: n1 ∈
    :data:`ct_plan.RADIX_N1` and a = 8 (8 | n2), as every planned length
    with such an n1 splits. n1 = 128 or 256: the cluster design, c from
    :func:`cluster_size`, the column tile; n1 = 384, 640, 896: the wide
    design (c = 8, n1/8 columns a block). Only the kernel variants these
    reach are built. Raises ValueError otherwise."""
    n1, n2 = ct_plan.ct_split(n)
    if n1 not in ct_plan.RADIX_N1:
        raise ValueError(f"the long-row K3 takes n1 in {ct_plan.RADIX_N1}; nfft {n} = {n1}·{n2}")
    _, a, r = ct_plan.radix_split(n)
    if a != ct_plan.RADIX_MAX_A:
        raise ValueError(f"the long-row K3 takes n2 a multiple of {ct_plan.RADIX_MAX_A}; nfft {n} = {n1}·{n2}")
    if n1 in CLUSTER_N1:
        c = cluster_size(n1, n2)
        return LongGeometry(n1, n2, a, r, "cluster", c, 32 if n2 <= 512 and (n1 // c) % 32 == 0 else 16)
    if r > wide_max_r(n1) or wide_smem(n1, n2, True) > SMEM_LIMIT:  # pragma: no cover — n2 ≤ 336 up to 131072
        raise ValueError(f"the wide K1/K3 takes {n1}·n2 within one block's shared memory; nfft {n} = {n1}·{n2}")
    return LongGeometry(n1, n2, a, r, "wide", WIDE_C, n1 // WIDE_C)


def fft_rows_ct_long(re: torch.Tensor, im: torch.Tensor):
    """:func:`fft_rows_ct` through the long-row design on CUDA rows of a
    length :func:`long_geometry` takes (the wrapper routes only n >
    :data:`MAX_N` here; the card tests also force shorter rows through
    it, where its spectra equal the one-block design's bit for bit).
    Counted under ``design_counts["wide"]`` at n1 = 384, 640, 896, else
    ``"long"``."""
    global launch_count
    _check(re, im)
    if re.device.type != "cuda":
        raise ValueError(f"the long-row K3 runs on CUDA tensors, not {re.device}")
    out = long_rows(re, im)
    launch_count += 1
    design_counts["wide" if long_geometry(re.shape[-1]).design == "wide" else "long"] += 1
    return out


def long_rows(re: torch.Tensor, im: torch.Tensor):
    """The long-row design on contiguous float32 CUDA rows, counted by the
    caller: K3 as one launch of K3, kernel K1's long rows as part of one
    launch of K1. A launch the card refuses raises."""
    n = re.shape[-1]
    g = long_geometry(n)
    rows = re.numel() // n
    if g.design == "wide":
        return wide_launch(re, im)
    w1, wn2, _ = ct_plan.device_radix_tables(n, re.device)
    tw = ct_plan.device_tables(n, False, re.device).tw
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(re.device).cuda_stream)
    fn = build.kernel("rm_fft_rows_ct_cluster", _CLUSTER_ARGTYPES)
    err = fn(
        ptr(re), ptr(im), ptr(w1), ptr(wn2), ptr(device_step_b_roots(n, re.device)), ptr(tw), ptr(fr), ptr(fi),
        rows, g.n1, g.n2, g.a, g.r, g.c, stream,
    )
    build.check(err, "fft_rows_ct_long (cluster)")
    return fr, fi


def workspace_rows(re: torch.Tensor, im: torch.Tensor):
    """The workspace design (``csrc/fft_rows_ct_long.cu``) on contiguous
    float32 CUDA rows with n1 ∈ {384, 640, 896}, uncounted: no route
    reaches it; it is the comparison the card tests, ``chip_smoke.py`` and
    ``tools/forward_times.py`` hold the wide design against."""
    n = re.shape[-1]
    n1, n2 = ct_plan.ct_split(n)
    _, a, r = ct_plan.radix_split(n)
    rows = re.numel() // n
    if n1 not in (384, 640, 896) or a != ct_plan.RADIX_MAX_A or n2 > 512 or rows > WORKSPACE_MAX_ROWS:
        raise ValueError(f"the workspace K3 takes n1 in (384, 640, 896), 8 | n2 ≤ 512; nfft {n} = {n1}·{n2}")
    w1, wn2, wr = ct_plan.device_radix_tables(n, re.device)
    tw = ct_plan.device_tables(n, False, re.device).tw
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    ws = torch.empty((rows, n, 2), dtype=torch.float32, device=re.device)  # [rows, n2, n1] slot rows
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    fn = build.kernel("rm_fft_rows_ct_long", _WORKSPACE_ARGTYPES)
    err = fn(ptr(re), ptr(im), ptr(w1), ptr(wn2), ptr(wr), ptr(tw), ptr(ws), ptr(fr), ptr(fi),
             rows, n1, n2, a, r, ctypes.c_void_p(torch.cuda.current_stream(re.device).cuda_stream))
    build.check(err, "fft_rows_ct_long (workspace)")
    return fr, fi


def wide_launch(re: torch.Tensor, im: torch.Tensor, detect: tuple = (), args: tuple = (), topk: int = 0):
    """One launch of the wide kernel, uncounted; returns the spectra
    ``(fr, fi)``. With ``detect`` empty its detect half is off (K3); K1's
    launch (``fft_detect.wide_detect``) passes its four outputs (segment
    scores and offsets ``[rows, nfft/8]``, floor and row max ``[rows]``)
    and its detection parameters (``rm_det::DetectParams``' order) to turn
    it on; ``topk`` = K in 1..128 (``emit_topk``, with ``detect``) takes
    the top-K instantiation, whose first two outputs are ``[rows, 128]``
    top-K values and packed indices. Rows must start on 16 bytes (the
    column loads are 16 bytes wide); a launch the card refuses (no cluster
    of this shape fits) raises."""
    n = re.shape[-1]
    g = long_geometry(n)
    if g.design != "wide":
        raise ValueError(f"the wide K1/K3 takes n1 in {WIDE_N1}; nfft {n} = {g.n1}·{g.n2}")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError("the wide K1/K3 takes rows that start on 16 bytes")
    if len(detect) not in (0, 4) or len(args) != (8 if detect else 0):
        raise ValueError("the wide K1 takes four outputs and eight detection parameters, or neither")
    if topk and not detect:
        raise ValueError("the wide K3 has no top-K: topk needs the detect half")
    dev, rows = re.device, re.numel() // n
    w1, wn2, wr = ct_plan.device_radix_tables(n, dev)
    tw = ct_plan.device_tables(n, False, dev).tw
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    fn = build.kernel("rm_fft_detect_wide", _WIDE_ARGTYPES)
    err = fn(
        ptr(re), ptr(im), ptr(w1), ptr(wn2), ptr(wr), ptr(tw), ptr(fr), ptr(fi),
        *(ptr(x) for x in (detect or (None,) * 4)), rows, g.n1, g.n2, g.a, g.r, int(bool(detect)),
        *(args or (0, 0, 0, 0.0, 0, 0.0, 0.0, 0)), topk,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    build.check(err, "wide K1/K3")
    return fr, fi


def wide_info(n: int, detect: bool = True, topk: int = 0) -> dict:
    """The wide design at n on the current card (``topk`` > 0 with
    ``detect``: K1's top-K instantiation): ``c``, dynamic shared
    memory a block (``smem``), blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), active clusters
    (``cudaOccupancyMaxActiveClusters``; 0 would mean the card cannot run
    it), registers a thread, local memory in bytes and the launch bounds'
    blocks an SM of the instantiation it launches (``min_blocks``: 2, at
    most 64 registers a thread, or 1, at most 128)."""
    g = long_geometry(n)
    if g.design != "wide":
        raise ValueError(f"nfft {n} does not take the wide design")
    vals = [ctypes.c_int(0) for _ in range(6)]
    fn = build.kernel("rm_fft_detect_wide_info", _WIDE_INFO_ARGTYPES)
    build.check(fn(g.n1, g.n2, g.a, g.r, int(detect), topk if detect else 0, *(ctypes.byref(v) for v in vals)),
                "wide_info")
    smem, blocks, clusters, registers, local, min_blocks = (v.value for v in vals)
    return {"c": g.c, "smem": smem, "blocks": blocks, "clusters": clusters, "registers": registers,
            "local_bytes": local, "min_blocks": min_blocks}


@functools.lru_cache(maxsize=8)
def device_step_b_roots(n: int, device: torch.device) -> torch.Tensor:
    """Step B's roots for the long design: :func:`ct_plan.radix_tables`'
    ``wr`` (W_r^(j·s), [r, r, 2]) with each row padded to an even length
    rp with zeros, ``[r, rp, 2]``, so a lane reads the roots of two
    consecutive outputs as one 16-byte load. The same float32 values."""
    wr = ct_plan.radix_tables(n).wr
    r = wr.shape[0]
    out = np.zeros((r, r + (r & 1), 2), np.float32)
    out[:, :r] = wr
    return torch.from_numpy(out).to(device)


def cluster_info(n: int) -> dict:
    """The long design's cluster at n on the current card: ``c``, shared
    memory a block (``smem``) and ``cudaOccupancyMaxActiveClusters``
    (``clusters``; 0 would mean the card cannot run it). Raises for a
    length the wide design takes."""
    g = long_geometry(n)
    if g.design != "cluster":
        raise ValueError(f"nfft {n} takes the {g.design} design, not the cluster design")
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    fn = build.kernel("rm_fft_rows_ct_cluster_info", _INFO_ARGTYPES)
    build.check(fn(g.n1, g.n2, g.a, g.r, g.c, ctypes.byref(smem), ctypes.byref(clusters)), "cluster_info")
    return {"c": g.c, "smem": smem.value, "clusters": clusters.value}


def _launch(re, im):
    global launch_count
    n = re.shape[-1]
    n2, a, r = ct_plan.radix_split(n)
    fn = build.kernel("rm_fft_rows_ct", _ARGTYPES)
    w128, wn2, wr = ct_plan.device_radix_tables(n, re.device)
    tw = ct_plan.device_tables(n, False, re.device).tw
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = fn(
        ptr(re), ptr(im), ptr(w128), ptr(wn2), ptr(wr), ptr(tw), ptr(fr), ptr(fi),
        re.numel() // n, n2, a, r,
        ctypes.c_void_p(torch.cuda.current_stream(re.device).cuda_stream),
    )
    build.check(err, "fft_rows_ct")
    launch_count += 1
    design_counts["block"] += 1
    return fr, fi


def fft_rows_ct_plain(re: torch.Tensor, im: torch.Tensor):
    """Plain PyTorch version of K3: the same function as the four-step
    DFT on ``ct_constants``' tables, as batched tensor ops. Same contract
    as :func:`fft_rows_ct`. On the card it is the comparison only, with
    ``torch.backends.cuda.matmul.allow_tf32 = False`` set by the caller
    (full FP32 products). Through :func:`fft_rows_ct` on the CPU it runs
    at one intra-op thread (:func:`device.cpu_single_thread`, fault F2)."""
    shape = re.shape
    n = shape[-1]
    n1, n2 = ct_plan.ct_split(n)
    t = ct_plan.device_tables(n, False, re.device)
    xr = re.reshape(-1, n2, n1)  # x[r, q, p] at time q·n1 + p
    xi = im.reshape(-1, n2, n1)
    # inner DFT over q: B[r, k2, p] = Σ_q W2[k2, q] x[r, q, p]
    br = t.w2re @ xr - t.w2im @ xi
    bi = t.w2re @ xi + t.w2im @ xr
    # twiddle W_n^{p·k2}
    cr = br * t.twre - bi * t.twim
    ci = br * t.twim + bi * t.twre
    # outer DFT over p: D[r, k2, k1] = Σ_p C[r, k2, p] W1[p, k1]; flat m = k2·n1 + k1
    fr = (cr @ t.w1re - ci @ t.w1im).reshape(shape)
    fi = (cr @ t.w1im + ci @ t.w1re).reshape(shape)
    return fr, fi
