"""Batched demodulators: FM / AM / USB / LSB, deemphasis, squelch,
decimation, resampling, the FIR channelizer and the multi-frequency watch
block (rtl_fm parity).

Port of ``radio_mapper_tpu/ops/demod.py``, with the same names and
arguments, on complex64 tensors ``[..., N]`` on any device. Every function
is batched over the leading axes, so many channels demodulate in one call.
Three places differ in form from the reference, not in result:

- ``deemphasis``: the reference's ``lax.scan`` over samples becomes a
  blocked one-pole recurrence (:func:`_one_pole`): within a chunk of
  ``CHUNK`` samples a lower-triangular ``c^(i−j)`` table applied as
  float32 products and sums, then the chunk ends carried by the same form
  one level up. No per-sample loop, no negative powers, no matmul (so no
  TF32 path, whatever the global flags say).
- the oscillators of ``_analytic_shift`` and ``channelize_watch`` are
  built in numpy float64 and cast to complex64, as the reference builds
  them, cached by (length, offsets, rate) and copied to the device once.
- ``fir_decimate``: the reference's static-index gather and HIGHEST
  einsum become an ``unfold`` view of the left-padded real and imaginary
  planes and float32 products summed over the taps: no index tensor, no
  convolution (cuDNN's TF32 default), no matmul.

``resample_pow2`` goes through :func:`.fft.fft`/:func:`.fft.ifft`, which
send 16384, 32768 and 65536 points to kernel K7 on the card.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch.ops import fft as fft_ops

CHUNK = 64  # samples per chunk of the blocked deemphasis recurrence


@functools.lru_cache(maxsize=16)
def _oscillator(n: int, freqs_hz: Tuple[float, ...], sample_rate_hz: float, device: torch.device) -> torch.Tensor:
    """``exp(2πi·f·t)`` for each ``f`` in ``freqs_hz``, ``[len(freqs), n]``
    complex64 on ``device``, built in numpy float64 (a float32 phase loses
    a 1 MHz offset entirely by 240,000 samples)."""
    t = np.arange(n) / sample_rate_hz
    osc = np.exp(2j * np.pi * np.outer(np.asarray(freqs_hz, np.float64), t)).astype(np.complex64)
    return torch.from_numpy(osc).to(device)


def fm_demod(iq: torch.Tensor, *, gain: float = 1.0, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Polar-discriminant FM: angle(x[n] · conj(x[n−1])).

    ``prev``: the last sample of the previous block per batch element
    (``[..., 1]``, carried for streaming continuity); defaults to the first
    sample (a zero first output).
    """
    if prev is None:
        prev = iq[..., :1]
    shifted = torch.cat([prev.to(iq.dtype), iq[..., :-1]], dim=-1)
    return torch.angle(iq * shifted.conj()) * gain


def am_demod(iq: torch.Tensor) -> torch.Tensor:
    """Magnitude AM demod, DC-removed."""
    mag = iq.abs()
    return mag - mag.mean(dim=-1, keepdim=True)


def _analytic_shift(iq: torch.Tensor, sign: float, sample_rate_hz: float, bfo_hz: float) -> torch.Tensor:
    osc = _oscillator(iq.shape[-1], (float(sign * bfo_hz),), float(sample_rate_hz), iq.device)[0]
    return iq * osc


def usb_demod(iq: torch.Tensor, *, sample_rate_hz: float, bfo_hz: float = 1500.0) -> torch.Tensor:
    """Upper sideband: shift the (already channel-filtered) signal down by
    the BFO and take the real part."""
    return _analytic_shift(iq, -1.0, sample_rate_hz, bfo_hz).real


def lsb_demod(iq: torch.Tensor, *, sample_rate_hz: float, bfo_hz: float = 1500.0) -> torch.Tensor:
    return _analytic_shift(iq, +1.0, sample_rate_hz, bfo_hz).real


@functools.lru_cache(maxsize=32)
def _decay_table(c: float, length: int, device: torch.device) -> torch.Tensor:
    """``[length, length]`` float32: ``c^(i−j)`` for ``j ≤ i``, else 0;
    built in float64 from nonnegative powers only."""
    i = np.arange(length)
    d = i[:, None] - i[None, :]
    table = np.where(d >= 0, c ** np.maximum(d, 0).astype(np.float64), 0.0)
    return torch.from_numpy(table.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=32)
def _powers(c: float, length: int, device: torch.device) -> torch.Tensor:
    """``[length]`` float32: ``c^(i+1)``."""
    return torch.from_numpy((c ** np.arange(1, length + 1, dtype=np.float64)).astype(np.float32)).to(device)


def _one_pole(u: torch.Tensor, c: float, init: torch.Tensor) -> torch.Tensor:
    """``y[n] = c·y[n−1] + u[n]`` over the last axis of float32 ``u``, with
    ``y[−1] = init [...]``, for ``0 ≤ c < 1``.

    Chunks of ``L = min(CHUNK, N)`` samples: inside a chunk
    ``z[i] = Σ_{j≤i} c^(i−j)·u[j]`` (products with the lower-triangular
    table, summed), the chunk ends ``Y_k = z_k[L−1] + c^L·Y_{k−1}`` are the
    same recurrence one level up (recursively, ``⌈log_L N⌉`` levels), and
    ``y_k[i] = z_k[i] + c^(i+1)·Y_{k−1}``.
    """
    n = u.shape[-1]
    length = min(CHUNK, n)
    pad = (-n) % length
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
    lead = u.shape[:-1]
    chunks = u.reshape(*lead, -1, length)  # [..., C, L]
    table = _decay_table(c, length, u.device)
    z = (chunks.unsqueeze(-2) * table).sum(-1)  # [..., C, L]
    ends = z[..., -1]  # [..., C]
    c_len = c ** length
    if ends.shape[-1] > 1:
        carried = _one_pole(ends, c_len, init)  # Y_k
    else:
        carried = ends + c_len * init.unsqueeze(-1)
    prev = torch.cat([init.unsqueeze(-1), carried[..., :-1]], dim=-1)  # Y_{k−1}
    y = z + _powers(c, length, u.device) * prev.unsqueeze(-1)
    return y.reshape(*lead, -1)[..., :n]


def deemphasis(
    audio: torch.Tensor, *, sample_rate_hz: float, tau_s: float = 75e-6, init: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pole deemphasis IIR ``y[n] = y[n−1] + a·(x[n] − y[n−1])``, i.e.
    ``y[n] = (1−a)·y[n−1] + a·x[n]``, by the blocked recurrence of
    :func:`_one_pole`.

    Returns ``(audio, final_state [..., 1])`` so streaming callers can carry
    state; ``init`` (``[..., 1]``) defaults to the first sample.
    """
    a = 1.0 - float(np.exp(-1.0 / (sample_rate_hz * tau_s)))
    y0 = audio[..., :1] if init is None else init.to(audio.dtype)
    y = _one_pole(a * audio, 1.0 - a, y0[..., 0])
    return y, y[..., -1:]


def dc_block(audio: torch.Tensor) -> torch.Tensor:
    """Block-mean DC removal."""
    return audio - audio.mean(dim=-1, keepdim=True)


def squelch(iq: torch.Tensor, threshold_power: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Power gate: zero blocks whose mean power is below threshold.
    Returns ``(gated_iq, open_mask [...])``."""
    power = (iq.abs() ** 2).mean(dim=-1)
    open_ = power >= threshold_power
    return iq * open_.unsqueeze(-1).to(iq.dtype), open_


def decimate(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Boxcar-average decimation; the trailing remainder is dropped."""
    n = x.shape[-1] - x.shape[-1] % factor
    return x[..., :n].reshape(*x.shape[:-1], n // factor, factor).mean(dim=-1)


def resample_pow2(audio: torch.Tensor, out_len: int) -> torch.Tensor:
    """Band-limited resampling by FFT-domain truncation or zero-padding."""
    n = audio.shape[-1]
    spec = fft_ops.fft(audio.to(torch.complex64))
    half = min(n, out_len) // 2
    out_spec = torch.zeros((*audio.shape[:-1], out_len), dtype=torch.complex64, device=audio.device)
    out_spec[..., :half] = spec[..., :half]
    out_spec[..., out_len - half:] = spec[..., n - half:]
    return fft_ops.ifft(out_spec).real * (out_len / n)


def nbfm_pipeline(
    iq: torch.Tensor,
    *,
    sample_rate_hz: float,
    audio_rate_hz: float = 16_000.0,
    deemph_tau_s: Optional[float] = None,
) -> torch.Tensor:
    """Narrowband-FM chain (``rtl_fm -M fm``): demod → decimate → DC block;
    deemphasis only when ``deemph_tau_s`` is given."""
    audio = fm_demod(iq)
    factor = max(1, int(round(sample_rate_hz / audio_rate_hz)))
    audio = decimate(audio, factor)
    if deemph_tau_s:
        audio, _ = deemphasis(audio, sample_rate_hz=sample_rate_hz / factor, tau_s=deemph_tau_s)
    return dc_block(audio)


@functools.lru_cache(maxsize=32)
def _fir_taps(factor: int, taps_per_phase: int, cutoff: float, device: torch.device) -> torch.Tensor:
    t = taps_per_phase * factor
    k = np.arange(t) - (t - 1) / 2.0
    h = np.sinc(k * cutoff / factor) * np.hamming(t)
    return torch.from_numpy((h / h.sum()).astype(np.float32)).to(device)


def _fir_plane(x: torch.Tensor, h: torch.Tensor, factor: int) -> torch.Tensor:
    """``Σ_t frames[..., m, t]·h[t]`` of one float32 plane: the frames are an
    ``unfold`` view of the left-padded plane, m = n // factor of them."""
    t = h.shape[0]
    m = x.shape[-1] // factor
    frames = torch.nn.functional.pad(x, (t - 1, 0)).unfold(-1, t, factor)[..., :m, :]
    return (frames * h).sum(-1)


def fir_decimate(x: torch.Tensor, factor: int, *, taps_per_phase: int = 8, cutoff: float = 0.45) -> torch.Tensor:
    """Anti-alias FIR + ↓factor (windowed-sinc polyphase decimator, ~50 dB
    stopband). ``cutoff`` is the passband edge as a fraction of the output
    Nyquist. Complex input is filtered as its real and imaginary planes."""
    if factor <= 1:
        return x
    h = _fir_taps(factor, taps_per_phase, float(cutoff), x.device)
    if x.is_complex():
        return torch.complex(_fir_plane(x.real, h, factor), _fir_plane(x.imag, h, factor))
    return _fir_plane(x.to(torch.float32), h, factor)


def channelize_watch(
    iq: torch.Tensor,
    *,
    sample_rate_hz: float,
    offsets_hz: Tuple[float, ...],
    channel_rate_hz: float,
) -> torch.Tensor:
    """Extract W watch channels from one wideband capture, batched: mix the
    block down by each offset and FIR-decimate to the channel rate.
    Returns ``[..., W, M]`` complex64."""
    n = iq.shape[-1]
    factor = max(1, int(round(sample_rate_hz / channel_rate_hz)))
    offsets = tuple(-float(f) for f in offsets_hz)
    mixed = iq.unsqueeze(-2) * _oscillator(n, offsets, float(sample_rate_hz), iq.device)  # [..., W, N]
    return fir_decimate(mixed, factor)


def watch_demod_block(
    iq: torch.Tensor,
    *,
    sample_rate_hz: float,
    offsets_hz: Tuple[float, ...],
    mode: str = "nbfm",
    channel_rate_hz: float = 256_000.0,
    audio_rate_hz: float = 16_000.0,
    squelch_threshold: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block → per-watch-frequency audio with per-channel squelch.

    Returns ``(audio [..., W, A], open [..., W] bool)``; squelched
    channels' audio is zeroed.
    """
    ch = channelize_watch(iq, sample_rate_hz=sample_rate_hz, offsets_hz=offsets_hz, channel_rate_hz=channel_rate_hz)
    if squelch_threshold > 0:
        gated, open_ = squelch(ch, squelch_threshold)
    else:
        gated, open_ = ch, torch.ones(ch.shape[:-1], dtype=torch.bool, device=ch.device)
    audio_factor = max(1, int(round(channel_rate_hz / audio_rate_hz)))
    if mode == "nbfm":
        audio = nbfm_pipeline(gated, sample_rate_hz=channel_rate_hz, audio_rate_hz=audio_rate_hz)
    elif mode == "wbfm":
        audio = wbfm_pipeline(gated, sample_rate_hz=channel_rate_hz, audio_rate_hz=audio_rate_hz)
    elif mode == "am":
        audio = decimate(am_demod(gated), audio_factor)
    elif mode == "usb":
        audio = decimate(usb_demod(gated, sample_rate_hz=channel_rate_hz), audio_factor)
    elif mode == "lsb":
        audio = decimate(lsb_demod(gated, sample_rate_hz=channel_rate_hz), audio_factor)
    else:
        raise ValueError(f"unknown demod mode {mode!r}")
    return audio * open_.unsqueeze(-1).to(audio.dtype), open_


def wbfm_pipeline(
    iq: torch.Tensor,
    *,
    sample_rate_hz: float,
    audio_rate_hz: float = 32_000.0,
    deemph_tau_s: float = 75e-6,
) -> torch.Tensor:
    """Wideband-FM receive chain: FM demod → decimate → deemphasis → DC block."""
    audio = fm_demod(iq)
    factor = max(1, int(round(sample_rate_hz / audio_rate_hz)))
    audio = decimate(audio, factor)
    audio, _ = deemphasis(audio, sample_rate_hz=sample_rate_hz / factor, tau_s=deemph_tau_s)
    return dc_block(audio)
