"""Streaming (stateful) channelization: overlap-save across blocks.

Port of the sequential half of ``radio_mapper_tpu/models/streaming.py``
(``ChannelizerState``, ``StreamingChannelizer``). The channelizer carries
its (T−1)·M-sample filter history from block to block, so back-to-back
calls produce the same channel samples as one call on the concatenated
stream (after the same zero history). The sharded half
(``sharded_channelize``, a halo exchange over a mesh axis) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from radio_mapper_tpu_torch.ops import channelizer as pfb


class ChannelizerState(NamedTuple):
    tail: torch.Tensor  # [..., (T-1)*M] complex64 carried filter history


class StreamingChannelizer:
    """Overlap-save PFB channelizer with its state on ``device`` (the card
    by default; CPU callers pass ``device="cpu"``)."""

    def __init__(
        self,
        num_channels: int,
        *,
        sample_rate_hz: float,
        taps_per_channel: int = 8,
        device: torch.device | str = "cuda",
    ):
        self.m = num_channels
        self.taps = taps_per_channel
        self.sample_rate_hz = sample_rate_hz
        self.history = (taps_per_channel - 1) * num_channels
        self.device = torch.device(device)

    def init_state(self, batch_shape: Tuple[int, ...] = ()) -> ChannelizerState:
        """The stream-start state: a zero history."""
        return ChannelizerState(
            tail=torch.zeros((*batch_shape, self.history), dtype=torch.complex64, device=self.device)
        )

    def step(
        self, state: ChannelizerState, block: torch.Tensor
    ) -> Tuple[ChannelizerState, pfb.ChannelizedStream]:
        """Channelize one complex block ``[..., L]`` (L a multiple of M):
        exactly L/M frames a channel, gap-free across calls."""
        if block.shape[-1] % self.m != 0:
            raise ValueError(f"block length {block.shape[-1]} not a multiple of {self.m}")
        ext = torch.cat([state.tail, block.to(torch.complex64)], dim=-1)
        out = pfb.channelize(
            ext, self.m, sample_rate_hz=self.sample_rate_hz, taps_per_channel=self.taps
        )
        return ChannelizerState(tail=ext[..., -self.history:]), out
