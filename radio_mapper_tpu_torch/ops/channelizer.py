"""Polyphase filterbank (PFB) channelizer: prototype filter, the
polyphase multiply-adds, and the complex channelizer.

Port of ``radio_mapper_tpu/ops/channelizer.py`` (``prototype_filter``,
``polyphase_filter_apply``, ``ChannelizedStream``, ``channelize``). One
wideband stream of M·F samples is cut into columns of M, weighted by the
polyphase-reshaped prototype lowpass (T taps per branch) and summed over
the T taps; a branch DFT over M (:func:`channelize_parts`, under both
:func:`channelize` and :func:`.split_complex.channelize_split`) then
yields M baseband subchannels at fs/M. The reference runs these as plain XLA ops
(no kernel), so they are plain PyTorch ops here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from radio_mapper_tpu_torch.ops import fft as fft_ops


@functools.lru_cache(maxsize=None)
def prototype_filter(num_channels: int, taps_per_channel: int = 8, beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, cutoff at the channel half-width.

    Returns ``[taps_per_channel, num_channels]`` float32 — the polyphase
    matrix, normalized for unity DC gain per branch sum. The same numpy
    arithmetic as the reference, so the table is bit-identical.
    """
    m, t = num_channels, taps_per_channel
    n = m * t
    k = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(k / m) * np.kaiser(n, beta)
    h = h / np.sum(h)
    # Polyphase decomposition: branch p takes taps p, p+M, p+2M, ...
    return (h.reshape(t, m) * m).astype(np.float32)


@functools.lru_cache(maxsize=16)
def prototype_filter_on(num_channels: int, taps_per_channel: int, device: torch.device) -> torch.Tensor:
    """:func:`prototype_filter` as a tensor on ``device`` (built once)."""
    return torch.from_numpy(prototype_filter(num_channels, taps_per_channel)).to(device)


def polyphase_filter_apply(cols: torch.Tensor, h: torch.Tensor, num_frames: int) -> torch.Tensor:
    """``filtered[..., f, m] = Σ_t cols[..., f+t, m] · h[t, m]`` as T
    shifted multiply-adds in ascending t (the reference's order), reading
    T slices of one buffer instead of materializing ``[..., F, T, M]``
    frames."""
    t = h.shape[0]
    acc = cols[..., 0:num_frames, :] * h[0]
    for k in range(1, t):
        acc = acc + cols[..., k : k + num_frames, :] * h[k]
    return acc


def channelize_parts(
    re: torch.Tensor,
    im: torch.Tensor,
    num_channels: int,
    *,
    taps_per_channel: int = 8,
    shift: bool = True,
):
    """The channelizer on the real and imaginary parts ``[..., N]`` of one
    stream: ``(ch_re, ch_im)`` ``[..., M, F]``, F = N/M − T + 1 frames.

    The prototype is real, so each part is filtered on its own by the same
    taps, and only the M-point branch DFT mixes them. Channel c is the
    offset c·fs/M (aliased) unless ``shift``, which rolls the channel axis
    by M/2 so offsets increase from −fs/2.
    """
    m, t = num_channels, taps_per_channel
    n = re.shape[-1]
    if n % m != 0:
        raise ValueError(f"block length {n} must be a multiple of num_channels {m}")
    num_cols = n // m
    num_frames = num_cols - t + 1
    if num_frames <= 0:
        raise ValueError(f"need at least {m * t} samples, got {n}")
    h = prototype_filter_on(m, t, re.device)

    def filter_part(x):
        return polyphase_filter_apply(x.reshape(*x.shape[:-1], num_cols, m), h, num_frames)

    cre, cim = fft_ops.fft_re_im(filter_part(re), filter_part(im))  # branch DFT over M
    cre = cre.movedim(-1, -2)
    cim = cim.movedim(-1, -2)
    if shift:
        cre = torch.roll(cre, m // 2, dims=-2)
        cim = torch.roll(cim, m // 2, dims=-2)
    return cre, cim


class ChannelizedStream(NamedTuple):
    channels: torch.Tensor  # [..., M, F] complex64 per-channel baseband
    channel_offset_hz: np.ndarray  # [M] static: offset of each channel centre
    channel_rate_hz: float


def channelize(
    x: torch.Tensor,
    num_channels: int,
    *,
    sample_rate_hz: float,
    taps_per_channel: int = 8,
    shift: bool = True,
) -> ChannelizedStream:
    """Split complex ``[..., N]`` wideband IQ into ``num_channels`` basebands
    ``[..., M, F]`` complex64 (:func:`channelize_parts`; streaming callers
    carry the (T−1)·M-sample history: :mod:`..models.streaming`). The
    reference multiplies by the taps as complex numbers with zero
    imaginary part: the same values. With ``shift`` the channels are
    ordered by increasing offset, −fs/2 … +fs/2.
    """
    ch = torch.complex(*channelize_parts(
        x.real, x.imag, num_channels, taps_per_channel=taps_per_channel, shift=shift
    ))
    offsets = np.fft.fftfreq(num_channels, d=1.0 / sample_rate_hz)
    if shift:
        offsets = np.fft.fftshift(offsets)
    return ChannelizedStream(channels=ch, channel_offset_hz=offsets, channel_rate_hz=sample_rate_hz / num_channels)


def synthesize_tone_response(num_channels: int, taps_per_channel: int = 8, points: int = 512) -> np.ndarray:
    """|H(f)| of the prototype across ±2 channel widths (float64, numpy;
    for tests and docs)."""
    h = prototype_filter(num_channels, taps_per_channel).reshape(-1) / num_channels
    w = np.linspace(0, 2.0 / num_channels, points)
    e = np.exp(-2j * np.pi * np.outer(w, np.arange(h.size)))
    return np.abs(e @ h)
