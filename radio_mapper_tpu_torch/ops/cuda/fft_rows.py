"""Kernel K3: forward CT-order four-step FFT of rows.

Replaces ``radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows_ct`` (body
``fft_kernel.ct_fft_core``). The CUDA source is
``radio_mapper_tpu_torch/csrc/fft_rows_ct.cu``; its two DFT stages are
the ones kernel K1 runs (``csrc/ct_dft.cuh``).

Design (first, simple version): one thread block per row keeps the row
(re+im, 40,960 B at the wideband nfft 5120) in shared memory; the inner
n2-point DFT over q with the twiddle folded into its write-back, then the
outer n1-point DFT over p, both in place, in FP32 FMA on the CUDA cores
with the tables of :func:`ct_plan.ct_constants`; the spectra are written
once, in CT order. Two 512-thread blocks share an SM (launch bounds cap
registers at 64 a thread; shared memory allows five rows).

What bounds it on the H100: the direct DFT stages, n·(n1+n2) complex
multiply-adds per row (0.86 M at 5120 = 128·40) — compute and
shared-memory-issue bound; a row is read and its spectrum written once
(80 KB per row). The wideband path launches it once per block on all
M·B = 1024 rows. Left for later PRs: the DFT stages on tensor cores,
TMA row loads, and fusing the transform into the pair stage.

Precision: the reference's module default (``precision=None``) runs the
products as explicit bf16x3; the PHAT chain passes ``"default"``, which
is plain float32 on the CPU. The kernel and its plain version run
float32 (the caller disables TF32 for the plain version's products).
"""

from __future__ import annotations

import ctypes

import torch

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build

launch_count = 0  # launches of the CUDA kernel (not of the plain version)

THREADS = 512  # must match K3_THREADS in fft_rows_ct.cu
MAX_N2 = 256  # inner-DFT register tile: n2 ≤ (THREADS/32)·K3_MAX_KJ
MAX_N = 24_576  # the same row range as kernel K1
SMEM_LIMIT = 232_448  # H100 per-block shared memory

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
        return fft_rows_ct_plain(re, im)
    if re.device.type != "cuda":
        raise ValueError(f"no K3 implementation for device {re.device}")
    return _launch(re, im)


def _launch(re, im):
    global launch_count
    n = re.shape[-1]
    n1, n2 = ct_plan.ct_split(n)
    if THREADS % n1 or n2 > MAX_N2 or n > MAX_N or n * 8 > SMEM_LIMIT:
        raise ValueError(
            f"K3 supports n1 dividing {THREADS}, n2 ≤ {MAX_N2} and nfft ≤ {MAX_N} "
            f"(one row in shared memory); got nfft {n} = {n1}·{n2}"
        )
    fn = build.kernel("rm_fft_rows_ct", _ARGTYPES)
    t = ct_plan.device_tables(n, False, re.device)
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = fn(
        ptr(re), ptr(im), ptr(t.w1), ptr(t.w2), ptr(t.tw), ptr(fr), ptr(fi),
        re.numel() // n, n1, n2,
        ctypes.c_void_p(torch.cuda.current_stream(re.device).cuda_stream),
    )
    build.check(err, "fft_rows_ct")
    launch_count += 1
    return fr, fi


def fft_rows_ct_plain(re: torch.Tensor, im: torch.Tensor):
    """Plain PyTorch version of K3: the same four-step math on the same
    tables, as batched tensor ops. Same contract as :func:`fft_rows_ct`.
    On the card it is the comparison only, with
    ``torch.backends.cuda.matmul.allow_tf32 = False`` set by the caller
    (full FP32 products)."""
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
