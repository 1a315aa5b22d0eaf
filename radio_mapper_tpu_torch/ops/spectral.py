"""Spectral analysis: the complex power spectrum, bin frequencies,
framing, Welch averaging, spectrograms and the −3 dB bandwidth walk.

Port of ``radio_mapper_tpu/ops/spectral.py`` (``power_spectrum_db``,
``fft_frequencies_hz``, ``absolute_frequencies_hz``, ``frame_signal``,
``welch_psd_db``, ``spectrogram_db``, ``estimate_bandwidth_hz`` with its
safe-mode branch — the one the TPU runs: a boxcar built from rolls and a
gather-free walk). Everything is batched over leading axes; the
transforms go through :func:`.fft.fft` (kernel K7 on the card at the
lengths it routes there).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops import safe
from radio_mapper_tpu_torch.ops.windows import get_window

DB_EPS = 1e-12


def power_spectrum_db(
    iq: torch.Tensor,
    *,
    window: Optional[str] = None,
    nfft: Optional[int] = None,
    shift: bool = False,
) -> torch.Tensor:
    """``20·log10(|FFT(iq)| + 1e-12)`` over the last axis of complex
    ``[..., N]``, optionally windowed, zero-padded or cut to ``nfft``, and
    fftshifted. The transform is :func:`.fft.fft`: kernel K7 on the card
    at 16384, 32768 and 65536 points."""
    n = iq.shape[-1]
    if window is not None:
        iq = iq * torch.from_numpy(get_window(window, n)).to(iq.device)
    x = fft_ops.fft(iq, n=nfft)
    if shift:
        x = fft_ops.fftshift(x)
    return 20.0 * torch.log10(x.abs() + DB_EPS)


def fft_frequencies_hz(n: int, sample_rate_hz: float, *, shift: bool = False) -> np.ndarray:
    """Baseband bin frequencies of an ``n``-point FFT (numpy; static),
    fftshifted with ``shift``."""
    f = np.fft.fftfreq(n, d=1.0 / sample_rate_hz)
    return np.fft.fftshift(f) if shift else f


def absolute_frequencies_hz(
    n: int, sample_rate_hz: float, center_frequency_hz: float, *, shift: bool = False
) -> np.ndarray:
    """Absolute RF frequency of each bin."""
    return fft_frequencies_hz(n, sample_rate_hz, shift=shift) + center_frequency_hz


def frame_signal(iq: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """Overlapping frames of ``[..., N]``: ``[..., num_frames, frame_len]``,
    the trailing remainder dropped."""
    n = iq.shape[-1]
    num_frames = 1 + (n - frame_len) // hop if n >= frame_len else 0
    if num_frames <= 0:
        raise ValueError(f"signal length {n} < frame_len {frame_len}")
    idx = np.arange(num_frames)[:, None] * hop + np.arange(frame_len)[None, :]
    return iq[..., torch.as_tensor(idx, device=iq.device)]


def _windowed_frame_spectra(iq, nfft, overlap, window):
    hop = max(1, int(nfft * (1.0 - overlap)))
    frames = frame_signal(iq, nfft, hop)
    w = torch.from_numpy(get_window(window, nfft)).to(frames.device)
    return fft_ops.fft(frames * w)


def welch_psd_db(
    iq: torch.Tensor,
    *,
    nfft: int = 1024,
    overlap: float = 0.5,
    window: str = "hann",
    shift: bool = True,
    reduce: str = "mean",
) -> torch.Tensor:
    """Welch-averaged power spectral density in dB, ``[..., nfft]``:
    windowed frames at ``overlap``, |X|² averaged over the frames (or their
    per-bin maximum, ``reduce="peak"``: rtl_power's peak hold), then
    ``10·log10(p + 1e-12)``."""
    if reduce not in ("mean", "peak"):
        raise ValueError(f"unknown reduce {reduce!r}")
    mag2 = _windowed_frame_spectra(iq, nfft, overlap, window).abs() ** 2
    p = mag2.amax(dim=-2) if reduce == "peak" else mag2.mean(dim=-2)
    if shift:
        p = fft_ops.fftshift(p)
    return 10.0 * torch.log10(p + DB_EPS)


def spectrogram_db(
    iq: torch.Tensor,
    *,
    nfft: int = 1024,
    overlap: float = 0.5,
    window: str = "hann",
    shift: bool = True,
) -> torch.Tensor:
    """Per-frame power spectra ``[..., num_frames, nfft]`` in dB."""
    spec = _windowed_frame_spectra(iq, nfft, overlap, window)
    if shift:
        spec = fft_ops.fftshift(spec)
    return 20.0 * torch.log10(spec.abs() + DB_EPS)


def estimate_bandwidth_hz(
    power_db: torch.Tensor,
    peak_bin: torch.Tensor,
    sample_rate_hz: float,
    *,
    drop_db: float = 3.0,
    max_halfwidth_bins: int = 256,
    smooth_bins: int = 1,
) -> torch.Tensor:
    """−3 dB bandwidth around a peak bin.

    Args:
      power_db: ``[..., F]`` spectra (leading dims broadcast against
        ``peak_bin``).
      peak_bin: ``[...]`` integer peak indices.
      smooth_bins: odd boxcar width (circular) applied before the walk.
    Returns:
      ``[...]`` float32 bandwidth in Hz: the distance between the first
      bins more than ``drop_db`` below the peak on each side, each side
      capped at ``max_halfwidth_bins``, at least one bin.
    """
    f = power_db.shape[-1]
    if smooth_bins > 1:
        h = smooth_bins // 2
        acc = power_db
        for d in range(1, h + 1):
            acc = acc + torch.roll(power_db, d, dims=-1)
            acc = acc + torch.roll(power_db, -d, dims=-1)
        power_db = acc / smooth_bins
    shape = torch.broadcast_shapes(power_db.shape[:-1], peak_bin.shape)
    power_db = power_db.expand(*shape, f)
    peak_bin = peak_bin.to(torch.int64).expand(shape)
    peak_val = safe.take1_last(power_db, peak_bin)
    delta = torch.arange(f, device=power_db.device) - peak_bin.unsqueeze(-1)
    below = power_db < (peak_val.unsqueeze(-1) - drop_db)
    big = max_halfwidth_bins
    first_right = torch.where(below & (delta > 0), delta, big).amin(dim=-1).clamp(max=big)
    first_left = torch.where(below & (delta < 0), -delta, big).amin(dim=-1).clamp(max=big)
    width_bins = torch.clamp(first_right + first_left, min=1)
    return width_bins.to(torch.float32) * (sample_rate_hz / f)
