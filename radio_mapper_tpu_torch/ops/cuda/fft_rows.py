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
256, 384, 640, 896) and 8 | n2 (``csrc/fft_rows_ct_long.cu``,
:func:`fft_rows_ct_long`, :func:`long_geometry`): the same steps in two
passes through a [rows, n] float2 workspace that the wrapper allocates
(277 MB at [1024, 33792]). A column pass takes a tile of 32 (or, for
n2 > 512, 16) columns of a row, runs steps A and B on it (streamed for
r > 24) and writes the slot rows to the workspace; a row pass runs step
C, one warp a slot row (P = n1/32 points a lane: five radix-2 stages
across lanes, then radix-2 in registers for P = 4, 8, or two radix-2
stages and a direct q-point DFT for P = 4q = 12, 20, 28), and stores in
CT order. At r ≤ 24 its spectra equal the one-block design's bit for
bit. Every planned length up to 131072 has such a split.

What bounds it on the H100: device-memory bytes — a row read and its
spectrum written once, 80 KB a row at 5120 (twice that for the long
design's workspace round trip) — and then the three block barriers
between a row's loads and its stores; the arithmetic is n1·a·r² complex
FMAs a row for step B plus the radix-2 butterflies (the direct four-step
DFT it replaced issued n·(n1 + n2) from shared memory).
Kernels K1 and K8 run the same steps (``ct_fft.cuh`` ``fft_power_row``)
and store the same spectra. The wideband path launches it once per block
on all M·B = 1024 rows; the two-kernel flagship route on 1024 rows of
17408; the single-dwell step's long rows (block_len 32768: 33792) run
the long design.
Left for later PRs: TMA row loads, tensor cores, and the long rows across
a thread-block cluster instead of the workspace.

Precision: the reference's module default (``precision=None``) runs the
products as explicit bf16x3; the PHAT chain passes ``"default"``, which
is plain float32 on the CPU. The kernel and its plain version run
float32 (the caller disables TF32 for the plain version's products).
"""

from __future__ import annotations

import ctypes

import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build

launch_count = 0  # launches of the CUDA kernel (not of the plain version)
design_counts = {"block": 0, "long": 0}  # the same launches, by design

MAX_N = 24_576  # the one-block design's limit: one row in a block's shared memory (as kernel K1's)
LONG_MAX_ROWS = 65_535  # the column pass's grid rows

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_LONG_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


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


def long_geometry(n: int):
    """``(n1, n2, a, r)`` of a row the long-row design takes: n1 ∈
    :data:`ct_plan.RADIX_N1` and a = 8 (8 | n2), as every planned length
    with such an n1 splits. Only these column-pass variants are built:
    32 columns for n2 ≤ 512, 16 above, step B's inputs in registers up to
    r = 24 and 2, 3 or 4 outputs a thread above. Raises ValueError
    otherwise."""
    n1, n2 = ct_plan.ct_split(n)
    if n1 not in ct_plan.RADIX_N1:
        raise ValueError(f"the long-row K3 takes n1 in {ct_plan.RADIX_N1}; nfft {n} = {n1}·{n2}")
    _, a, r = ct_plan.radix_split(n)
    if a != ct_plan.RADIX_MAX_A:
        raise ValueError(f"the long-row K3 takes n2 a multiple of {ct_plan.RADIX_MAX_A}; nfft {n} = {n1}·{n2}")
    return n1, n2, a, r


def fft_rows_ct_long(re: torch.Tensor, im: torch.Tensor):
    """:func:`fft_rows_ct` through the long-row design on CUDA rows of a
    length :func:`long_geometry` takes (the wrapper routes only n >
    :data:`MAX_N` here; the card tests also force shorter rows through
    it, where its spectra equal the one-block design's bit for bit)."""
    global launch_count
    _check(re, im)
    if re.device.type != "cuda":
        raise ValueError(f"the long-row K3 runs on CUDA tensors, not {re.device}")
    out = long_rows(re, im)
    launch_count += 1
    design_counts["long"] += 1
    return out


def long_rows(re: torch.Tensor, im: torch.Tensor):
    """The long-row design's two passes on contiguous float32 CUDA rows,
    counted by the caller: K3 as one launch of K3, kernel K1's long rows
    as part of one launch of K1."""
    n = re.shape[-1]
    n1, n2, a, r = long_geometry(n)
    rows = re.numel() // n
    if rows > LONG_MAX_ROWS:
        raise ValueError(f"the long-row K3 takes at most {LONG_MAX_ROWS} rows, got {rows}")
    fn = build.kernel("rm_fft_rows_ct_long", _LONG_ARGTYPES)
    w1, wn2, wr = ct_plan.device_radix_tables(n, re.device)
    tw = ct_plan.device_tables(n, False, re.device).tw
    ws = torch.empty((rows, n, 2), dtype=torch.float32, device=re.device)  # [rows, n2, n1] slot rows
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = fn(
        ptr(re), ptr(im), ptr(w1), ptr(wn2), ptr(wr), ptr(tw), ptr(ws), ptr(fr), ptr(fi),
        rows, n1, n2, a, r,
        ctypes.c_void_p(torch.cuda.current_stream(re.device).cuda_stream),
    )
    build.check(err, "fft_rows_ct_long")
    return fr, fi


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
