"""Kernel K3: forward CT-order FFT of rows.

Replaces ``radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows_ct`` (body
``fft_kernel.ct_fft_core``). The CUDA source is
``radio_mapper_tpu_torch/csrc/fft_rows_ct.cu``; its steps are
``csrc/ct_fft.cuh``.

Design: one 512-thread block per row keeps the row (re+im, 40,960 B at
the wideband nfft 5120) in shared memory. Every length K3 takes splits as
n = 128·n2 with n2 = a·r, a = min(8, 2^v₂(n2)) (:func:`ct_plan.radix_split`):
step A runs an a-point radix-2 FFT in registers; step B the direct
r-point DFT with the row twiddle folded into its write (its r ≤ 24
inputs in registers, as on every length the pipelines plan; streamed
from shared memory above that); step C one warp per 128-point row, a
radix-2 FFT across lanes with ``__shfl_xor_sync`` that stores the
spectra, coalesced, in CT order. All twiddles are float32 tables of
float64 roots of unity (:func:`ct_plan.radix_tables`, ``ct_constants``'
twiddle).

What bounds it on the H100: device-memory bytes — a row read and its
spectrum written once, 80 KB a row at 5120 — and then the three block
barriers between a row's loads and its stores; the arithmetic is 128·a·r²
complex FMAs a row for step B plus the radix-2 butterflies (the direct
four-step DFT it replaced issued n·(128 + n2) from shared memory).
Kernels K1 and K8 run the same steps (``ct_fft.cuh`` ``fft_power_row``)
and store the same spectra. The wideband path launches it once per block
on all M·B = 1024 rows; the two-kernel flagship route on 1024 rows of
17408.
Left for later PRs: TMA row loads and tensor cores.

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

MAX_N = 24_576  # one row in a block's shared memory; the same row range as kernel K1

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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
    the kernel.
    """
    _check(re, im)
    if re.device.type == "cpu":
        with device.cpu_single_thread():
            return fft_rows_ct_plain(re, im)
    if re.device.type != "cuda":
        raise ValueError(f"no K3 implementation for device {re.device}")
    return _launch(re, im)


def _launch(re, im):
    global launch_count
    n = re.shape[-1]
    n2, a, r = ct_plan.radix_split(n)  # raises unless n1 = 128
    if n > MAX_N:
        raise ValueError(
            f"K3 supports nfft = 128·n2 ≤ {MAX_N} (one row in shared memory); got nfft {n} = 128·{n2}"
        )
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
