"""Kernel K2: all-pairs PHAT whitening × inverse DFT × lag window.

Replaces ``radio_mapper_tpu/ops/pallas/gcc_kernel.py::gcc_pair_lag_mags``
(body ``_gcc_pairs_kernel`` + ``_whiten`` + ``_invert_to_lag_windows``)
on the main path's routing: "phat" weighting with the per-receiver "l2rx"
gate, whose scale ``row_smax`` comes from kernel K1. The CUDA source is
``radio_mapper_tpu_torch/csrc/gcc_pair.cu``.

Design (first, simple version): one thread block per (channel, pair).
It gathers X_i and Y_j by index straight from the CT-order spectra (the
TPU's one-hot matmul gather is a layout device with no use here), forms
R = X·conj(Y), applies R·rsqrt(|R|² + ε²·max|X_i|²·max|Y_j|² + 1e-30),
and runs the four-step inverse in chunks of CT rows: the inner n1-point
inverse DFT over k1 and the inverse twiddle, then the outer inverse DFT
over k2 accumulated ONLY into the lag-window time rows (``ceil(L/n1)``
tail rows and ``L//n1 + 1`` head rows). Shared memory holds one chunk
and the window accumulators (≈ 26 KB at the flagship shape), so several
blocks share an SM. FP32 FMA on the CUDA cores.

What bounds it on the H100: the inner inverse DFT, n·n1 complex
multiply-adds per pair (≈ 2.2 M at nfft 17408, 28 pairs × 128 channels
a block) — compute bound; each pair reads two spectra (≈ 0.28 MB, mostly
L2 hits since a channel's 8 spectra are shared by its 28 pairs). Left
for later PRs: both DFT stages on tensor cores, TMA loads of the spectra
rows, and fusing K1 into this kernel so spectra stay on chip.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build

launch_count = 0  # launches of the CUDA kernel (not of the plain version)

THREADS = 256  # must match K2_THREADS in gcc_pair.cu
RJ = 8  # must match K2_RJ in gcc_pair.cu
SMEM_LIMIT = 232_448  # H100 per-block shared memory

_ARGTYPES = (
    [ctypes.c_void_p] * 9
    + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_float]
    + [ctypes.c_void_p]
)


def window_rows(nfft: int, max_lag: int):
    """``(nneg, npos)``: CT time rows (length n1 each) holding lags
    −max_lag..−1 (tail rows) and 0..max_lag (head rows)."""
    n1, _ = ct_plan.ct_split(nfft)
    return -(-max_lag // n1), max_lag // n1 + 1


@functools.lru_cache(maxsize=16)
def _pair_tensors(pair_i: tuple, pair_j: tuple, device: torch.device):
    to = lambda p: torch.tensor(p, dtype=torch.int32, device=device)
    return to(pair_i), to(pair_j)


def _check(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag):
    if spec_re.shape != spec_im.shape or spec_re.dim() != 3:
        raise ValueError(f"need spectra [C, B, nfft], got {tuple(spec_re.shape)}, {tuple(spec_im.shape)}")
    c, b, nfft = spec_re.shape
    if c < 1:
        raise ValueError("need at least one channel")
    if row_smax.shape != (c, b):
        raise ValueError(f"row_smax {tuple(row_smax.shape)} does not match spectra [{c}, {b}, ·]")
    for name, x in (("spec_re", spec_re), ("spec_im", spec_im), ("row_smax", row_smax)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != spec_re.device:
            raise ValueError(f"{name} on {x.device}, spectra on {spec_re.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    pi = np.asarray(pair_i)
    pj = np.asarray(pair_j)
    if pi.ndim != 1 or pi.shape != pj.shape or pi.size < 1:
        raise ValueError("pair_i/pair_j must be equal-length 1-D index arrays")
    if pi.min() < 0 or pj.min() < 0 or pi.max() >= b or pj.max() >= b:
        raise ValueError(f"pair indices out of range for {b} receivers")
    if not 0 <= max_lag < nfft // 2:
        raise ValueError(f"max_lag {max_lag} too large for nfft {nfft}")
    ct_plan.ct_split(nfft)


def gcc_pair_lag_mags(
    spec_re: torch.Tensor,
    spec_im: torch.Tensor,
    row_smax: torch.Tensor,
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    *,
    max_lag: int,
    eps: float = 0.05,
) -> torch.Tensor:
    """PHAT correlation magnitudes |r|/nfft at lags −max_lag..+max_lag.

    Args:
      spec_re/spec_im: float32 ``[C, B, nfft]`` CT-order spectra (K1 output).
      row_smax: float32 ``[C, B]`` per-receiver max linear power (K1 output).
      pair_i/pair_j: host int arrays of length P (receiver i, receiver j).
    Returns:
      float32 ``[C, P, 2·max_lag+1]``; lag > 0 ⇒ receiver i heard later.

    CPU tensors go through :func:`gcc_pair_lag_mags_plain`; CUDA tensors
    launch the kernel.
    """
    _check(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag)
    if spec_re.device.type == "cpu":
        return gcc_pair_lag_mags_plain(
            spec_re, spec_im, row_smax, pair_i, pair_j, max_lag=max_lag, eps=eps
        )
    if spec_re.device.type != "cuda":
        raise ValueError(f"no K2 implementation for device {spec_re.device}")
    return _launch(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps)


def _launch(spec_re, spec_im, row_smax, pair_i, pair_j, max_lag, eps):
    global launch_count
    c, b, n = spec_re.shape
    n1, n2 = ct_plan.ct_split(n)
    if THREADS % n1:
        raise ValueError(f"K2 supports n1 dividing {THREADS}; got nfft {n} = {n1}·{n2}")
    nneg, npos = window_rows(n, max_lag)
    smem = ((THREADS // n1) * RJ + nneg + npos) * n1 * 8
    if smem > SMEM_LIMIT:
        raise ValueError(f"max_lag {max_lag} needs {smem} B of shared memory (limit {SMEM_LIMIT})")
    fn = build.kernel("rm_gcc_pair_lag_mags", _ARGTYPES)
    t = ct_plan.device_tables(n, True, spec_re.device)
    pi, pj = _pair_tensors(
        tuple(int(v) for v in pair_i), tuple(int(v) for v in pair_j), spec_re.device
    )
    p = pi.shape[0]
    out = torch.empty((c, p, 2 * max_lag + 1), dtype=torch.float32, device=spec_re.device)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = fn(
        ptr(spec_re), ptr(spec_im), ptr(row_smax), ptr(pi), ptr(pj),
        ptr(t.w1), ptr(t.w2), ptr(t.tw), ptr(out),
        c, b, p, n1, n2, nneg, npos, max_lag,
        eps * eps, 1.0 / n,
        ctypes.c_void_p(torch.cuda.current_stream(spec_re.device).cuda_stream),
    )
    build.check(err, "gcc_pair_lag_mags")
    launch_count += 1
    return out


def gcc_pair_lag_mags_plain(
    spec_re: torch.Tensor,
    spec_im: torch.Tensor,
    row_smax: torch.Tensor,
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    *,
    max_lag: int,
    eps: float = 0.05,
) -> torch.Tensor:
    """Plain PyTorch version of K2: the same whitening and four-step
    inverse on the same tables, as batched tensor ops. Same contract as
    :func:`gcc_pair_lag_mags`. On the card it is the comparison only,
    with ``torch.backends.cuda.matmul.allow_tf32 = False`` set by the
    caller (full FP32 products)."""
    c, b, n = spec_re.shape
    n1, n2 = ct_plan.ct_split(n)
    nneg, npos = window_rows(n, max_lag)
    t = ct_plan.device_tables(n, True, spec_re.device)
    pi = torch.as_tensor(np.asarray(pair_i, np.int64), device=spec_re.device)
    pj = torch.as_tensor(np.asarray(pair_j, np.int64), device=spec_re.device)
    p = pi.shape[0]

    xr, xi = spec_re[:, pi], spec_im[:, pi]  # [C, P, n]
    yr, yi = spec_re[:, pj], spec_im[:, pj]
    rr = xr * yr + xi * yi  # R = X · conj(Y)
    ri = xi * yr - xr * yi
    s2 = (row_smax[:, pi] * row_smax[:, pj]).unsqueeze(-1)  # ≥ max|R|² per pair
    inv = torch.rsqrt(rr * rr + ri * ri + (eps * eps) * s2 + 1e-30)
    rr = (rr * inv).reshape(c, p, n2, n1)
    ri = (ri * inv).reshape(c, p, n2, n1)

    # inner inverse DFT over k1, then the inverse twiddle W_n^{+p·k2}
    er = rr @ t.w1re - ri @ t.w1im
    ei = rr @ t.w1im + ri @ t.w1re
    cr = er * t.twre - ei * t.twim
    ci = er * t.twim + ei * t.twre
    # outer inverse DFT over k2, only for the lag-window time rows
    q = torch.cat([torch.arange(n2 - nneg, n2), torch.arange(npos)]).to(spec_re.device)
    w2r, w2i = t.w2re[q], t.w2im[q]  # [nw, n2]
    zr = w2r @ cr - w2i @ ci  # [C, P, nw, n1], time q·n1 + p
    zi = w2r @ ci + w2i @ cr
    mags = (torch.sqrt(zr * zr + zi * zi) * (1.0 / n)).reshape(c, p, (nneg + npos) * n1)
    # lags −L..−1 from the tail rows, 0..L from the head rows
    return mags[..., nneg * n1 - max_lag : nneg * n1 + max_lag + 1]
