"""Complex-input GCC (cross-correlation with a GCC weighting) and the
peak pick: integer argmax → parabolic sub-sample refine → PSR.

Port of ``radio_mapper_tpu/ops/gcc_phat.py``: ``next_pow2``,
``_weight_cross_spectrum`` (phat, scot, roth, cc), ``cross_correlate``,
``gcc_phat``, ``gcc_phat_all_pairs``, ``gcc_phat_all_pairs_coherent``
and the shared tail (``CorrelationPeak``, ``pair_indices``,
``parabolic_refine``, ``peak_to_sidelobe``, ``peaks_from_lag_mags``) with
the lowest-index argmax of :mod:`.safe`.

Complex inputs are split once into float32 (re, im) planes; the
weighting, the inverse transform and the lag window have one body on
planes (:func:`weighted_lag_window`), which the split-complex GCC of
:mod:`.split_complex` shares. Transforms go through :func:`.fft.fft_re_im`
and :func:`.fft.ifft_re_im` at the reference's 5-smooth nfft
(``friendly_fft_len``): kernel K7 on the card where that length is one
K7 takes, the matmul four-step otherwise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops import safe

WEIGHTINGS = ("cc", "phat", "scot", "roth")


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


class CorrelationPeak(NamedTuple):
    """Result of a (batched) GCC peak pick; fields are ``[...]`` shaped."""

    lag_samples: torch.Tensor  # float32 — sub-sample lag of x relative to y
    tau_s: torch.Tensor  # float32 — lag / sample_rate
    peak_value: torch.Tensor  # float32 — |r| at the (integer) peak
    psr: torch.Tensor  # float32 — peak-to-sidelobe ratio (quality metric)


def pair_indices(num_receivers: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (i, j) index arrays for all i<j pairs."""
    i, j = np.triu_indices(num_receivers, k=1)
    return i.astype(np.int32), j.astype(np.int32)


@functools.lru_cache(maxsize=32)
def pair_index_tensors(num_receivers: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pair_indices` as int64 tensors on ``device`` (built once)."""
    return tuple(torch.as_tensor(a, dtype=torch.int64, device=device) for a in pair_indices(num_receivers))


def _auto_powers(xfr, xfi, yfr, yfi, weighting: str):
    """``(|X|², |Y|²)`` where the weighting reads them (scot, roth), else
    ``(None, None)``."""
    if weighting not in ("scot", "roth"):
        return None, None
    return xfr * xfr + xfi * xfi, yfr * yfr + yfi * yfi


def _weight_cross_spectrum(
    rre: torch.Tensor, rim: torch.Tensor, px, py, weighting: str, eps: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A GCC weighting of the cross spectrum R = X·conj(Y) in planes
    ``(rre, rim)``: R / (D + eps·max D + 1e-30) with D = |R| ("phat"),
    √(px·py) ("scot"), px ("roth"), or R unweighted ("cc"); ``px, py``
    are the auto-powers |X|², |Y|² (dwell-averaged in the coherent GCC)."""
    if weighting not in WEIGHTINGS:
        raise ValueError(f"unknown weighting {weighting!r}; expected one of {WEIGHTINGS}")
    if weighting == "cc":
        return rre, rim
    if weighting == "phat":
        d = torch.sqrt(rre * rre + rim * rim)
    elif weighting == "scot":
        d = torch.sqrt(px * py)
    else:  # roth
        d = px
    denom = d + eps * d.amax(dim=-1, keepdim=True) + 1e-30
    return rre / denom, rim / denom


def _lag_window(rre: torch.Tensor, rim: torch.Tensor, max_lag: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weighted cross spectrum back to lags −max_lag..+max_lag:
    ``(re, im)`` of the GCC window ``[..., 2·max_lag+1]``."""
    nfft = rre.shape[-1]
    cre, cim = fft_ops.ifft_re_im(rre, rim)
    take = lambda a: torch.cat([a[..., nfft - max_lag:], a[..., : max_lag + 1]], dim=-1)
    return take(cre), take(cim)


def weighted_lag_window(
    xfr: torch.Tensor, xfi: torch.Tensor, yfr: torch.Tensor, yfi: torch.Tensor,
    *,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(re, im)`` of the weighted GCC at lags −max_lag..+max_lag from the
    spectra of x and y in planes ``[..., nfft]``."""
    rre = xfr * yfr + xfi * yfi  # R = X · conj(Y)
    rim = xfi * yfr - xfr * yfi
    px, py = _auto_powers(xfr, xfi, yfr, yfi, weighting)
    return _lag_window(*_weight_cross_spectrum(rre, rim, px, py, weighting, eps), max_lag)


def _planned_nfft(n: int, max_lag: int) -> int:
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < block length {n}")
    return fft_ops.friendly_fft_len(n + max_lag)


def _cross_correlate_planes(x, y, *, max_lag: int, weighting: str, eps: float):
    """:func:`cross_correlate` as ``(re, im)`` planes."""
    nfft = _planned_nfft(x.shape[-1], max_lag)
    xfr, xfi = fft_ops.fft_re_im(*fft_ops.re_im(x, nfft))
    yfr, yfi = fft_ops.fft_re_im(*fft_ops.re_im(y, nfft))
    return weighted_lag_window(xfr, xfi, yfr, yfi, max_lag=max_lag, weighting=weighting, eps=eps)


def cross_correlate(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> torch.Tensor:
    """Complex GCC of complex ``x, y [..., N]`` at lags −max_lag..+max_lag,
    ``[..., 2·max_lag+1]`` complex64; a positive lag means ``x`` is delayed
    relative to ``y``. Both are zero-padded to the 5-smooth
    ``friendly_fft_len(N + max_lag)`` (alias-free for ±max_lag)."""
    return torch.complex(*_cross_correlate_planes(x, y, max_lag=max_lag, weighting=weighting, eps=eps))


def parabolic_refine(m: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Sub-sample offset from the parabola through m[k−1], m[k], m[k+1];
    clamped to (−1, 1), 0 at the window edges or on a degenerate fit."""
    length = m.shape[-1]
    kc = torch.clamp(k, 1, length - 2)
    ym1 = safe.take1_last(m, kc - 1)
    y0 = safe.take1_last(m, kc)
    yp1 = safe.take1_last(m, kc + 1)
    denom = ym1 - 2.0 * y0 + yp1
    flat = denom.abs() < 1e-12
    delta = 0.5 * (ym1 - yp1) / torch.where(flat, 1.0, denom)
    delta = torch.clamp(torch.where(flat, 0.0, delta), -0.999, 0.999)
    return torch.where((k >= 1) & (k <= length - 2), delta, 0.0)


def peak_to_sidelobe(m: torch.Tensor, k: torch.Tensor, *, exclude: int = 8) -> torch.Tensor:
    """Peak magnitude over the largest magnitude more than ``exclude`` lags away."""
    idx = torch.arange(m.shape[-1], device=m.device)
    dist = (idx - k.unsqueeze(-1)).abs()
    side_max = torch.where(dist > exclude, m, float("-inf")).amax(dim=-1)
    return safe.take1_last(m, k) / (torch.clamp(side_max, min=0.0) + 1e-12)


def peaks_from_lag_mags(
    m: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_lag: int,
    psr_exclude: int = 8,
) -> CorrelationPeak:
    """Peak pick from a ``[..., 2·max_lag+1]`` correlation-magnitude window."""
    k = safe.argmax_last(m)
    delta = parabolic_refine(m, k)
    lag = k.to(torch.float32) - float(max_lag) + delta
    return CorrelationPeak(
        lag_samples=lag,
        tau_s=lag / sample_rate_hz,
        peak_value=safe.take1_last(m, k),
        psr=peak_to_sidelobe(m, k, exclude=psr_exclude),
    )


def gcc_phat(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
    psr_exclude: int = 8,
) -> CorrelationPeak:
    """Sub-sample TDOA between ``x`` and ``y`` (positive ⇒ x arrived later)."""
    cre, cim = _cross_correlate_planes(x, y, max_lag=max_lag, weighting=weighting, eps=eps)
    return peaks_from_lag_mags(
        torch.sqrt(cre * cre + cim * cim), sample_rate_hz=sample_rate_hz, max_lag=max_lag, psr_exclude=psr_exclude
    )


def receiver_spectra(signals: torch.Tensor, *, max_lag: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Each receiver's spectrum once: complex ``signals [..., N]`` as planes
    zero-padded to ``nfft = friendly_fft_len(N + max_lag)`` and
    transformed. Returns ``(fr, fi, nfft)`` with ``fr/fi [..., nfft]``."""
    nfft = _planned_nfft(signals.shape[-1], max_lag)
    fr, fi = fft_ops.fft_re_im(*fft_ops.re_im(signals, nfft))
    return fr, fi, nfft


def pair_lag_mags(
    fr: torch.Tensor,
    fi: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    *,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> torch.Tensor:
    """|GCC| over lags −max_lag..+max_lag of every pair, ``[..., P, 2L+1]``,
    from natural-order receiver spectra ``fr/fi [..., B, nfft]`` and int64
    pair index tensors on their device: x = receiver i, y = receiver j
    (:func:`weighted_lag_window`)."""
    xfr, xfi = fr.index_select(-2, pair_i), fi.index_select(-2, pair_i)
    yfr, yfi = fr.index_select(-2, pair_j), fi.index_select(-2, pair_j)
    cre, cim = weighted_lag_window(xfr, xfi, yfr, yfi, max_lag=max_lag, weighting=weighting, eps=eps)
    return torch.sqrt(cre * cre + cim * cim)


def gcc_phat_all_pairs(
    signals: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> CorrelationPeak:
    """All i<j pairs over the receiver axis of complex ``signals [..., B, N]``:
    ``[..., P]`` fields in :func:`pair_indices` order, ``lag > 0`` ⇒
    receiver i heard the signal later than receiver j. Each receiver is
    transformed once (:func:`receiver_spectra`); the pairs combine the
    spectra (:func:`pair_lag_mags`)."""
    fr, fi, _ = receiver_spectra(signals, max_lag=max_lag)
    pair_i, pair_j = pair_index_tensors(signals.shape[-2], fr.device)
    mags = pair_lag_mags(fr, fi, pair_i, pair_j, max_lag=max_lag, weighting=weighting, eps=eps)
    return peaks_from_lag_mags(mags, sample_rate_hz=sample_rate_hz, max_lag=max_lag)


def gcc_phat_all_pairs_coherent(
    signals: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_lag: int,
    num_blocks: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> CorrelationPeak:
    """All pairs of ``[..., B, K·N]`` captures cut into K = ``num_blocks``
    dwells, the pair cross spectra averaged over the dwells before the
    weighting (scot/roth use the dwell-averaged auto-powers) and one
    inverse transform at ``friendly_fft_len(N + max_lag)``."""
    n_total = signals.shape[-1]
    if n_total % num_blocks:
        raise ValueError(f"capture {n_total} not divisible into {num_blocks} blocks")
    n = n_total // num_blocks
    nfft = _planned_nfft(n, max_lag)
    fr, fi = fft_ops.fft_re_im(*fft_ops.re_im(signals.reshape(*signals.shape[:-1], num_blocks, n), nfft))
    pair_i, pair_j = pair_index_tensors(signals.shape[-2], fr.device)
    xfr, xfi = fr.index_select(-3, pair_i), fi.index_select(-3, pair_i)  # [..., P, K, nfft]
    yfr, yfi = fr.index_select(-3, pair_j), fi.index_select(-3, pair_j)
    rre = (xfr * yfr + xfi * yfi).mean(dim=-2)
    rim = (xfi * yfr - xfr * yfi).mean(dim=-2)
    px, py = (None if p is None else p.mean(dim=-2) for p in _auto_powers(xfr, xfi, yfr, yfi, weighting))
    cre, cim = _lag_window(*_weight_cross_spectrum(rre, rim, px, py, weighting, eps), max_lag)
    return peaks_from_lag_mags(
        torch.sqrt(cre * cre + cim * cim), sample_rate_hz=sample_rate_hz, max_lag=max_lag
    )


# --- float64 golden model ----------------------------------------------------


def gcc_phat_numpy(
    x: np.ndarray,
    y: np.ndarray,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> Tuple[float, float, float]:
    """Float64 numpy reference of :func:`gcc_phat` (one pair, 1-D inputs),
    at the reference's 5-smooth nfft. Returns ``(lag_samples, tau_s,
    peak_value)``."""
    n = x.shape[-1]
    nfft = fft_ops.friendly_fft_len(n + max_lag)
    x_f = np.fft.fft(x, n=nfft)
    y_f = np.fft.fft(y, n=nfft)
    r = x_f * np.conj(y_f)
    if weighting == "phat":
        mag = np.abs(r)
        r = r / (mag + eps * mag.max() + 1e-30)
    elif weighting == "scot":
        d = np.sqrt(np.abs(x_f) ** 2 * np.abs(y_f) ** 2)
        r = r / (d + eps * d.max() + 1e-30)
    elif weighting == "roth":
        d = np.abs(x_f) ** 2
        r = r / (d + eps * d.max() + 1e-30)
    elif weighting != "cc":
        raise ValueError(f"unknown weighting {weighting!r}")
    corr = np.fft.ifft(r)
    m = np.abs(np.concatenate([corr[nfft - max_lag:], corr[: max_lag + 1]]))
    k = int(np.argmax(m))
    delta = 0.0
    if 1 <= k <= len(m) - 2:
        denom = m[k - 1] - 2.0 * m[k] + m[k + 1]
        if abs(denom) > 1e-12:
            delta = float(np.clip(0.5 * (m[k - 1] - m[k + 1]) / denom, -0.999, 0.999))
    lag = k - max_lag + delta
    return lag, lag / sample_rate_hz, float(m[k])
