"""Kernels K9 and K10: the narrowband pair stage on hand-written
mixed-radix FFTs at the reference's 5-smooth nfft.

Replace no TPU kernel: the JAX package computes this stage (the coherent
all-pairs GCC of a multi-dwell capture, and the complex step's) with XLA
dots, its matmul four-step, outside any Pallas kernel. The port's
four-step (:func:`..fft.fft_re_im_plain`) runs those dots as FP32 GEMMs of
DFT matrices: at nfft 135000 = 360·375 a row costs 0.79 GFLOP against a
radix FFT's 11.5 MFLOP, and the inverse of every pair is computed over all
135000 lags of which 2L + 1 are kept. These kernels keep the bin grid
(``friendly_fft_len``), the PHAT formula and float32, with no TF32 and no
library FFT (``csrc/pair_fft.cu`` on ``csrc/mixed_fft.cuh``):

- **K9** :func:`receiver_spectra`: the forward transform of every
  receiver row at N = N1·N2 (:data:`PLANS`: 135000 = 1080·125, 17280 =
  1080·16), the
  zero-padding in its loads: N2-point DFTs over the stride-N1 columns and
  the twiddle, then N1-point DFTs, in place. Its output is in the order
  K10 loads: ``[rows, N2, N1, 2]`` (re, im), ``spec[row, k2, k1]`` = bin
  N2·k1 + k2 (:func:`natural` undoes it); nothing else reads it.
- **the max pass** :func:`pair_max`: max |X_i·conj(X_j)| of every pair
  of a channel, the PHAT gate's scale, each receiver read once a channel.
- **K10** :func:`lag_mags`: one block a pair; for each of its N2 columns
  the whitened cross spectrum R/(|R| + eps·max|R| + 1e-30), the N1-point
  inverse FFT, and the columns' sum at the 2L + 1 window lags only:
  r[lag] = Σ_{n2} W_N^{−n2·lag}·Y_{n2}[lag mod N1], which needs N1 ≥ 2L + 1.

Each transform is a Stockham plan of radix-2/3/4/5/8 passes
(:data:`PLANS`' radices, first to last), run by a block in shared memory;
twiddles are float32 tables of float64 roots (:func:`tables`). What
bounds them on the H100, and what the design does about it, is in the
source's note. :func:`route` says when the pipeline's pair stage takes
them: a CUDA tensor at a length :data:`PLANS` covers, "phat", N1 ≥ 2L + 1
and at most :data:`MAX_RECEIVERS` receivers; everything else keeps the
four-step. The plain versions (:func:`receiver_spectra_plain`,
:func:`pair_max_plain`, :func:`lag_mags_plain`) run the same
decomposition with matmul DFTs; each wrapper runs them for CPU tensors.
``tests/test_torch_mixed_fft.py`` replays the kernels' schedules in numpy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build

launch_count = 0  # K9 launches (not of the plain version)
max_launch_count = 0  # max-pass launches
window_launch_count = 0  # K10 launches

OMEGA_LO = 512  # the two-level W_N table's low part (OMEGA_LO in mixed_fft.cuh)
MAX_RECEIVERS = 8  # the max pass is instantiated for 2..8 receivers


class Plan(NamedTuple):
    """N = n1·n2 and the Stockham radices of each factor, first to last
    (the plan structs of ``csrc/pair_fft.cu``)."""

    n1: int  # K10's inverse and K9's second step; ≥ 2L + 1
    n2: int  # K9's column DFTs; K10 sums its columns
    radix1: Tuple[int, ...]
    radix2: Tuple[int, ...]


PLANS = {
    135_000: Plan(1080, 125, (5, 3, 3, 8, 3), (5, 5, 5)),  # narrowband: friendly_fft_len(8·16384 + 512)
    17_280: Plan(1080, 16, (5, 3, 3, 8, 3), (4, 4)),  # the complex step: friendly_fft_len(16384 + 512)
}

_SPECTRA_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
_MAX_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
_WINDOW_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2
                    + [ctypes.c_void_p] * 5)


def route(nfft: int, dev: torch.device, weighting: str, *, max_lag: int, num_receivers: int) -> str:
    """``"kernels"`` (K9 → max pass → K10) or ``"four-step"``: where the
    pipeline's pair stage runs a capture whose spectra are ``nfft`` points
    on ``dev``. A pure function of its arguments."""
    plan = PLANS.get(nfft)
    if (dev.type == "cuda" and plan is not None and weighting == "phat"
            and 2 * max_lag + 1 <= plan.n1 and 2 <= num_receivers <= MAX_RECEIVERS):
        return "kernels"
    return "four-step"


class Tables(NamedTuple):
    """float32 ``[..., 2]`` (re, im) of float64 roots, each rounded once."""

    roots1: np.ndarray  # [n1]: W_n1^e
    roots2: np.ndarray  # [n2]: W_n2^e
    hi: np.ndarray  # [ceil(N / OMEGA_LO)]: W_N^(h·OMEGA_LO)
    lo: np.ndarray  # [OMEGA_LO]: W_N^l; W_N^e = hi[e // OMEGA_LO]·lo[e % OMEGA_LO]


@functools.lru_cache(maxsize=4)
def tables(nfft: int) -> Tables:
    p = PLANS[nfft]
    return Tables(
        roots1=ct_plan._roots(np.arange(p.n1), p.n1),
        roots2=ct_plan._roots(np.arange(p.n2), p.n2),
        hi=ct_plan._roots(np.arange(-(-nfft // OMEGA_LO)) * OMEGA_LO, nfft),
        lo=ct_plan._roots(np.arange(OMEGA_LO), nfft),
    )


@functools.lru_cache(maxsize=8)
def _device_tables(nfft: int, dev: torch.device) -> Tables:
    return Tables(*(torch.from_numpy(a).to(dev) for a in tables(nfft)))


@functools.lru_cache(maxsize=8)
def _device_pairs(num_receivers: int, dev: torch.device) -> torch.Tensor:
    i, j = np.triu_indices(num_receivers, k=1)
    return torch.from_numpy(np.stack([i, j], axis=-1).astype(np.int32)).to(dev)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def natural(spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Natural-order ``(re, im) [rows, N]`` of K9's ``[rows, N2, N1, 2]``."""
    rows, n2, n1, _ = spec.shape
    x = spec.transpose(1, 2).reshape(rows, n1 * n2, 2)
    return x[..., 0], x[..., 1]


# --- K9 -------------------------------------------------------------------


def receiver_spectra(re: torch.Tensor, im: torch.Tensor, nfft: int) -> torch.Tensor:
    """K9: the spectra ``[rows, N2, N1, 2]`` of float32 rows ``re/im
    [rows, len]`` (``len`` ≤ nfft, zero-padded to it), in K10's order
    (:func:`receiver_spectra_plain` states it). The rows may be strided
    views, as the decoded planes are, with one row and element stride
    for both."""
    global launch_count
    p = PLANS[nfft]
    rows, length = re.shape
    if im.shape != re.shape or re.dtype != torch.float32 or im.dtype != torch.float32 or length > nfft:
        raise ValueError(f"need float32 re/im [rows, ≤ {nfft}], got {re.dtype} {tuple(re.shape)}, "
                         f"{im.dtype} {tuple(im.shape)}")
    if re.device.type != "cuda":
        with device.cpu_single_thread():
            return receiver_spectra_plain(re, im, nfft)
    if re.stride() != im.stride() or im.device != re.device:
        re, im = re.contiguous(), im.contiguous()
    spec = torch.empty((rows, p.n2, p.n1, 2), dtype=torch.float32, device=re.device)
    if rows == 0:
        return spec
    t = _device_tables(nfft, re.device)
    fn = build.kernel("rm_pair_fft_spectra", _SPECTRA_ARGTYPES)
    err = fn(_ptr(re), _ptr(im), re.stride(0), re.stride(1), rows, length, p.n1, p.n2, _ptr(spec),
             _ptr(t.roots1), _ptr(t.roots2), _ptr(t.hi), _ptr(t.lo), _stream(re.device))
    build.check(err, "pair_fft spectra (K9)")
    launch_count += 1
    return spec


def receiver_spectra_plain(re: torch.Tensor, im: torch.Tensor, nfft: int) -> torch.Tensor:
    """K9's plain version: ``spec[row, k2, k1]`` = X[N2·k1 + k2], X the
    nfft-point DFT of the zero-padded row. Viewing the row as x[t1 + N1·t2]:
    the N2-point DFT over t2, times W_N^(t1·k2), then the N1-point DFT over
    t1, each a float32 product with its DFT matrix."""
    from radio_mapper_tpu_torch.ops import fft as fft_ops

    p = PLANS[nfft]
    rows, length = re.shape
    pad = lambda a: torch.nn.functional.pad(a.to(torch.float32), (0, nfft - length)).reshape(rows, p.n2, p.n1)
    xr, xi = pad(re), pad(im)
    dev = re.device
    w2r, w2i = (torch.from_numpy(a).to(dev) for a in fft_ops.dft_matrix(p.n2))
    ar, ai = w2r @ xr - w2i @ xi, w2r @ xi + w2i @ xr  # [rows, k2, t1]
    tr, ti = (torch.from_numpy(np.ascontiguousarray(a.T)).to(dev) for a in fft_ops.twiddle(p.n1, p.n2))
    ar, ai = ar * tr - ai * ti, ar * ti + ai * tr
    w1r, w1i = (torch.from_numpy(a).to(dev) for a in fft_ops.dft_matrix(p.n1))
    return torch.stack([ar @ w1r - ai @ w1i, ar @ w1i + ai @ w1r], dim=-1)


# --- the max pass ---------------------------------------------------------


def pair_max(spec: torch.Tensor, num_receivers: int) -> torch.Tensor:
    """``[chans, P]``: max over the bins of |X_i·conj(X_j)| for every pair
    i < j (``np.triu_indices`` order) of each channel's ``num_receivers``
    rows of ``spec [chans·B, N2, N1, 2]`` (any bin order)."""
    global max_launch_count
    b = num_receivers
    rows, n2, n1, _ = spec.shape
    if rows % b or not 2 <= b <= MAX_RECEIVERS:
        raise ValueError(f"{rows} rows are not whole channels of {b} receivers (2..{MAX_RECEIVERS})")
    chans = rows // b
    if spec.device.type != "cuda":
        with device.cpu_single_thread():
            return pair_max_plain(spec, b)
    pmax = torch.zeros((chans, b * (b - 1) // 2), dtype=torch.float32, device=spec.device)
    if chans == 0:
        return pmax
    fn = build.kernel("rm_pair_fft_max", _MAX_ARGTYPES)
    build.check(fn(_ptr(spec), chans, b, n1 * n2, _ptr(pmax), _stream(spec.device)), "pair_fft max pass")
    max_launch_count += 1
    return pmax


def _cross(spec: torch.Tensor, num_receivers: int):
    """``(rre, rim) [chans, P, ...]`` of R = X_i·conj(X_j), as the
    reference forms it."""
    i, j = np.triu_indices(num_receivers, k=1)
    x = spec.reshape(-1, num_receivers, *spec.shape[1:])
    xi, xj = x[:, torch.from_numpy(i)], x[:, torch.from_numpy(j)]
    xr, xim, yr, yim = xi[..., 0], xi[..., 1], xj[..., 0], xj[..., 1]
    return xr * yr + xim * yim, xim * yr - xr * yim


def pair_max_plain(spec: torch.Tensor, num_receivers: int) -> torch.Tensor:
    """:func:`pair_max`'s plain version."""
    rre, rim = _cross(spec, num_receivers)
    return torch.sqrt(rre * rre + rim * rim).flatten(2).amax(dim=-1)


# --- K10 ------------------------------------------------------------------


def lag_mags(spec: torch.Tensor, num_receivers: int, *, max_lag: int, eps: float) -> torch.Tensor:
    """The max pass, then K10: |GCC-PHAT| of every pair (``np.triu_indices``
    order, x = receiver i, y = receiver j) at lags −max_lag..+max_lag,
    ``[chans, P, 2L+1]``, from K9's spectra ``[chans·B, N2, N1, 2]``."""
    global window_launch_count
    b = num_receivers
    rows, n2, n1, _ = spec.shape
    nfft = n1 * n2
    plan = PLANS.get(nfft)
    if plan is None or (plan.n1, plan.n2) != (n1, n2):
        raise ValueError(f"no plan for spectra [.., {n2}, {n1}, 2]")
    if 2 * max_lag + 1 > n1:
        raise ValueError(f"the window 2·{max_lag} + 1 exceeds N1 = {n1}")
    pmax = pair_max(spec, b)
    if spec.device.type != "cuda":
        with device.cpu_single_thread():
            return lag_mags_plain(spec, pmax, b, max_lag=max_lag, eps=eps)
    chans, npairs = pmax.shape
    out = torch.empty((chans, npairs, 2 * max_lag + 1), dtype=torch.float32, device=spec.device)
    if chans == 0:
        return out
    t = _device_tables(nfft, spec.device)
    fn = build.kernel("rm_pair_fft_window", _WINDOW_ARGTYPES)
    err = fn(_ptr(spec), _ptr(pmax), _ptr(_device_pairs(b, spec.device)), chans, b, npairs, max_lag, eps,
             n1, n2, _ptr(out), _ptr(t.roots1), _ptr(t.hi), _ptr(t.lo), _stream(spec.device))
    build.check(err, "pair_fft window (K10)")
    window_launch_count += 1
    return out


def lag_mags_plain(spec: torch.Tensor, pmax: torch.Tensor, num_receivers: int, *, max_lag: int,
                   eps: float) -> torch.Tensor:
    """K10's plain version, the same decomposition: for each pair and
    column n2, Wh = R / (|R| + eps·pmax + 1e-30), its N1-point inverse DFT
    Y (a product with the conjugate DFT matrix), then r[lag] = Σ_{n2}
    W_N^(−n2·lag)·Y[n2, lag mod N1] / N and its magnitude."""
    from radio_mapper_tpu_torch.ops import fft as fft_ops

    _, n2, n1, _ = spec.shape
    nfft = n1 * n2
    dev = spec.device
    rre, rim = _cross(spec, num_receivers)  # [chans, P, n2, n1]
    den = torch.sqrt(rre * rre + rim * rim) + eps * pmax[..., None, None] + 1e-30
    wr, wi = rre / den, rim / den
    w1r, w1i = (torch.from_numpy(a).to(dev) for a in fft_ops.dft_matrix(n1))
    yr, yi = wr @ w1r + wi @ w1i, wi @ w1r - wr @ w1i  # times conj(W1)
    lags = np.arange(-max_lag, max_lag + 1)
    k1 = torch.from_numpy(lags % n1).to(dev)
    e = np.outer(np.arange(n2), lags) % nfft
    tr, ti = (torch.from_numpy(a).to(dev) for a in np.moveaxis(ct_plan._roots(e, nfft, inverse=True), -1, 0))
    yr, yi = yr[..., k1], yi[..., k1]  # [chans, P, n2, 2L+1]
    cr = (yr * tr - yi * ti).sum(dim=-2) / nfft
    ci = (yr * ti + yi * tr).sum(dim=-2) / nfft
    return torch.sqrt(cr * cr + ci * ci)
