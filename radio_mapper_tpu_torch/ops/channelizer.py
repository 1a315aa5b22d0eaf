"""Polyphase filterbank (PFB) channelizer: prototype filter and the
polyphase multiply-adds.

Port of ``radio_mapper_tpu/ops/channelizer.py`` (``prototype_filter``,
``polyphase_filter_apply``). One wideband stream of M·F samples is cut
into columns of M, weighted by the polyphase-reshaped prototype lowpass
(T taps per branch) and summed over the T taps; a branch DFT over M
(:func:`.split_complex.channelize_split`) then yields M baseband
subchannels at fs/M. The reference runs these as plain XLA ops (no
kernel), so they are plain PyTorch ops here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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
