"""Kernel K7: forward natural-order four-step FFT of rows.

Replaces ``radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows`` (body
``_fft_rows_kernel``; the ``fft``/``ifft`` wrappers are the conjugation
identity around it). The CUDA source is
``radio_mapper_tpu_torch/csrc/fft_rows.cu``.

Split and tables are the reference's (``fft_kernel._split``,
``_constants``), copied here and held equal to it by a test: n = n1·n2
with n2 the largest divisor ≤ √n and n1 ≤ 256; x[j + n1·q] is viewed as
``[n2, n1]``; inner n2-point DFT over q, twiddle exp(−2πi·j·k2/n), outer
n1-point DFT over j; bin k = k2 + n2·k1.

Design (first, simple version): two launches of one tiled complex
product kernel through a ``[rows, n1, n2]`` scratch — inner DFT with the
twiddle folded into its write-back, then the outer DFT, whose output is
already in natural order (the source says why two passes: a row of
32768 or 65536 points does not fit one block's shared memory). FP32 FMA
on the CUDA cores. The TPU kernel runs its products as explicit bf16x3
(module precision HIGH); FP32 is at least as precise.

What bounds it on the H100: the direct DFT stages, n·(n1+n2) complex
multiply-adds per row (4.2 M at 16384 = 128·128, 12.6 M at 32768,
33.6 M at 65536); the scratch adds 16 B of device traffic per point.
Left for later PRs: tensor cores, radix stages, TMA loads.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops.cuda import build

launch_count = 0  # calls that launched the CUDA kernel (not the plain version)

MAX_FACTOR = 256  # fft_kernel.MAX_FACTOR
THREADS = 256  # must match K7_THREADS in fft_rows.cu
TILE = 64  # must match K7_TILE: the kernel needs n1 and n2 multiples of it

_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
    """:func:`constants` on a device (planar float32)."""

    w1re: torch.Tensor  # [n1, n1]
    w1im: torch.Tensor
    w2re: torch.Tensor  # [n2, n2]
    w2im: torch.Tensor
    twre: torch.Tensor  # [n2, n1] — the plain version's layout
    twim: torch.Tensor
    twtre: torch.Tensor  # [n1, n2] — the kernel's (tw transposed, contiguous)
    twtim: torch.Tensor


@functools.lru_cache(maxsize=8)
def device_tables(n: int, device: torch.device) -> Tables:
    _, _, w1re, w1im, w2re, w2im, twre, twim = constants(n)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Tables(t(w1re), t(w1im), t(w2re), t(w2im), t(twre), t(twim), t(twre.T), t(twim.T))


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
    kernel, which needs both factors to be multiples of ``TILE`` and
    raises otherwise.
    """
    _check(re, im)
    if re.device.type == "cpu":
        with device.cpu_single_thread():
            return fft_rows_plain(re, im)
    if re.device.type != "cuda":
        raise ValueError(f"no K7 implementation for device {re.device}")
    return _launch(re, im)


def _launch(re, im):
    global launch_count
    n = re.shape[-1]
    n1, n2 = split(n)
    if n1 % TILE or n2 % TILE:
        raise ValueError(
            f"K7 needs both factors of n = n1·n2 to be multiples of {TILE}; got {n} = {n1}·{n2}"
        )
    fn = build.kernel("rm_fft_rows", _ARGTYPES)
    t = device_tables(n, re.device)
    scratch = (torch.empty_like(re), torch.empty_like(im))
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = fn(
        ptr(re), ptr(im), ptr(t.w1re), ptr(t.w1im), ptr(t.w2re), ptr(t.w2im),
        ptr(t.twtre), ptr(t.twtim), ptr(scratch[0]), ptr(scratch[1]), ptr(fr), ptr(fi),
        re.numel() // n, n1, n2,
        ctypes.c_void_p(torch.cuda.current_stream(re.device).cuda_stream),
    )
    build.check(err, "fft_rows")
    launch_count += 1
    return fr, fi


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
