"""Kernel K1: forward CT-order FFT + spectral detection in one pass per row.

Replaces ``radio_mapper_tpu/ops/pallas/detect_kernel.py::fft_detect_rows_ct``
(body ``fft_kernel.ct_fft_core`` + ``detect_kernel._detect_body``). The
CUDA source is ``radio_mapper_tpu_torch/csrc/fft_detect.cu``.

Design (first, simple version): one thread block per row keeps the whole
row (re+im, 139,264 B at nfft 17408) in shared memory; the four-step DFT
runs in place — inner n2-point DFT over q with the twiddle folded into
the write-back, then the outer n1-point DFT over p — in FP32 FMA on the
CUDA cores with the tables of :func:`ct_plan.ct_constants`. The spectra
are written once (the pair stage reads them); the detect body then runs
on the power array in shared memory: row max, the 24-step dB bisection
over the stride-8 subsample, the circular ±radius sliding max in natural
bin order, the gates, and the per-8-bin-segment (max, lowest argmax).

What bounds it on the H100: the two direct DFT stages, n·(n1+n2) complex
multiply-adds per row (≈ 37 MFLOP at 17408), issued from shared memory
and L1 — compute and load-issue bound, not HBM bound (the row is read and
the spectra written once, ≈ 0.28 MB per row). Left for later PRs: the DFT
stages on tensor cores (TF32/bf16 ``wgmma``), TMA row loads, and fusing
K1 into the pair stage (K2) so the spectra never reach device memory.
"""

from __future__ import annotations

import ctypes

import torch

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build

launch_count = 0  # launches of the CUDA kernel (not of the plain version)

THREADS = 512  # must match K1_THREADS in fft_detect.cu
MAX_N2 = 256  # inner-DFT register tile: n2 ≤ (THREADS/32)·K1_MAX_KJ
MAX_N = 24_576  # power held in registers: n ≤ THREADS·K1_MAX_PER_THREAD
SMEM_LIMIT = 232_448 - 256  # H100 per-block shared memory less the static part

_ARGTYPES = (
    [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    + [ctypes.c_void_p]
)


def _check(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan) -> None:
    if re.shape != im.shape or re.dim() != 2 or re.shape[0] < 1:
        raise ValueError(f"need re/im of one shape [rows ≥ 1, nfft], got {tuple(re.shape)}, {tuple(im.shape)}")
    if re.shape[-1] != plan.nfft:
        raise ValueError(f"rows of length {re.shape[-1]} but the plan is for nfft {plan.nfft}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"need float32, got {re.dtype}, {im.dtype}")
    if re.device != im.device:
        raise ValueError(f"re on {re.device}, im on {im.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("re/im must be contiguous")


def fft_detect_rows_ct(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan):
    """Forward CT-order FFT + fused detection of ``[rows, nfft]`` rows.

    Args:
      re/im: float32 ``[rows, nfft]`` time rows, already zero-padded.
      plan: :func:`ct_plan.detect_plan` for this nfft.
    Returns:
      ``(fr, fi, seg_score, seg_arg, noise_floor_db, row_max)``: CT-order
      spectra ``[rows, nfft]``; per-segment partials ``[rows, nfft/8]``
      (linear power, −inf where the segment holds no candidate; float
      in-segment offset 0-7 — segment f = b2·n1 + k1 covers natural bins
      (8·b2 + off) + n2·k1); the noise floor in dB and each row's max
      linear power, ``[rows]``.

    CPU tensors go through :func:`fft_detect_rows_ct_plain`; CUDA tensors
    launch the kernel.
    """
    _check(re, im, plan)
    if re.device.type == "cpu":
        return fft_detect_rows_ct_plain(re, im, plan)
    if re.device.type != "cuda":
        raise ValueError(f"no K1 implementation for device {re.device}")
    return _launch(re, im, plan)


def _launch(re, im, plan):
    global launch_count
    n1, n2, n = plan.n1, plan.n2, plan.nfft
    if THREADS % n1 or n2 > MAX_N2 or n > MAX_N or n * 8 > SMEM_LIMIT:
        raise ValueError(
            f"K1 supports n1 dividing {THREADS}, n2 ≤ {MAX_N2} and nfft ≤ {MAX_N} "
            f"(one row in shared memory); got nfft {n} = {n1}·{n2}"
        )
    fn = build.kernel("rm_fft_detect_rows_ct", _ARGTYPES)
    t = ct_plan.device_tables(n, False, re.device)
    rows = re.shape[0]
    s = plan.segments
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    score = torch.empty((rows, s), dtype=torch.float32, device=re.device)
    arg = torch.empty((rows, s), dtype=torch.float32, device=re.device)
    nf = torch.empty((rows,), dtype=torch.float32, device=re.device)
    rmax = torch.empty((rows,), dtype=torch.float32, device=re.device)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = fn(
        ptr(re), ptr(im), ptr(t.w1), ptr(t.w2), ptr(t.tw),
        ptr(fr), ptr(fi), ptr(score), ptr(arg), ptr(nf), ptr(rmax),
        rows, n1, n2, plan.radius, plan.keep_lo, plan.keep_hi,
        plan.thr_lin, int(plan.conf_cs is not None),
        0.0 if plan.conf_cs is None else plan.conf_cs,
        plan.power_offset_db, plan.bisect_iters,
        ctypes.c_void_p(torch.cuda.current_stream(re.device).cuda_stream),
    )
    build.check(err, "fft_detect_rows_ct")
    launch_count += 1
    return fr, fi, score, arg, nf, rmax


def fft_detect_rows_ct_plain(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan):
    """Plain PyTorch version of K1: the same four-step math on the same
    tables, as batched tensor ops. Same contract as
    :func:`fft_detect_rows_ct`. On the card it is the comparison only,
    with ``torch.backends.cuda.matmul.allow_tf32 = False`` set by the
    caller (full FP32 products)."""
    rows, n = re.shape
    n1, n2 = plan.n1, plan.n2
    t = ct_plan.device_tables(n, False, re.device)
    xr = re.reshape(rows, n2, n1)  # x[r, q, p] at time q·n1 + p
    xi = im.reshape(rows, n2, n1)
    # inner DFT over q: B[r, k2, p] = Σ_q W2[k2, q] x[r, q, p]
    br = t.w2re @ xr - t.w2im @ xi
    bi = t.w2re @ xi + t.w2im @ xr
    # twiddle W_n^{p·k2}
    cr = br * t.twre - bi * t.twim
    ci = br * t.twim + bi * t.twre
    # outer DFT over p: D[r, k2, k1] = Σ_p C[r, k2, p] W1[p, k1]; flat m = k2·n1 + k1
    fr = (cr @ t.w1re - ci @ t.w1im).reshape(rows, n)
    fi = (cr @ t.w1im + ci @ t.w1re).reshape(rows, n)
    return (fr, fi, *detect_plain(fr, fi, plan))


def detect_plain(fr: torch.Tensor, fi: torch.Tensor, plan: ct_plan.DetectPlan):
    """K1's detect body on CT-order spectra: ``(seg_score, seg_arg,
    noise_floor_db, row_max)`` (``detect_kernel._detect_body``)."""
    rows, n = fr.shape
    n1, n2, seg = plan.n1, plan.n2, ct_plan.SEGMENT
    n2g, s = n2 // seg, plan.segments
    off = plan.power_offset_db

    pr = fr * fr + fi * fi  # [rows, n] linear power, CT flat order
    row_max = pr.amax(dim=-1)

    # noise floor: stride-8 natural subsample = CT rows k2 ≡ 0 (mod 8),
    # bisected in dB; "below" tests an integer count against half
    sub = pr.reshape(rows, n2g, seg, n1)[:, :, 0, :].reshape(rows, s)
    sub_db = 10.0 * torch.log10(sub + 1e-24) + off
    lo = sub_db.amin(dim=-1)
    hi = sub_db.amax(dim=-1)
    for _ in range(plan.bisect_iters):
        mid = 0.5 * (lo + hi)
        count = (sub_db <= mid.unsqueeze(-1)).sum(dim=-1)
        below = 2 * count < s
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    nf = 0.5 * (lo + hi)

    # circular ±radius sliding max in natural bin order (k = k2 + n2·k1)
    r = plan.radius
    nat = pr.reshape(rows, n2, n1).transpose(1, 2).reshape(rows, n)
    ext = torch.cat([nat[:, n - r:], nat, nat[:, :r]], dim=-1)
    smax_nat = ext.unfold(-1, 2 * r + 1, 1).amax(dim=-1)
    smax = smax_nat.reshape(rows, n1, n2).transpose(1, 2).reshape(rows, n)

    # candidacy gates, all in linear power
    m = torch.arange(n, device=fr.device)
    k_nat = (m % n1) * n2 + m // n1
    cand = (pr >= smax) & (pr + 1e-24 > plan.thr_lin)
    cand &= (k_nat >= plan.keep_lo) & (k_nat <= plan.keep_hi)
    if plan.conf_cs is not None:
        conf_lin = torch.exp((nf - off + plan.conf_cs) * ct_plan.LN10_OVER_10)
        cand &= pr + 1e-24 >= conf_lin.unsqueeze(-1)
    score = torch.where(cand, pr, float("-inf"))

    # per-segment (max, lowest in-segment argmax): 8 CT rows of one column
    s4 = score.reshape(rows, n2g, seg, n1)
    seg_max = s4.amax(dim=2)
    offs = torch.arange(seg, device=fr.device).view(1, 1, seg, 1)
    seg_arg = torch.where(s4 >= seg_max.unsqueeze(2), offs, seg).amin(dim=2)
    return seg_max.reshape(rows, s), seg_arg.reshape(rows, s).to(torch.float32), nf, row_max
