"""Streaming (stateful) channelization: overlap-save across blocks.

Port of ``radio_mapper_tpu/models/streaming.py``. Two deployment shapes:

- **Sequential** (``ChannelizerState``, ``StreamingChannelizer``): the
  channelizer carries its (T−1)·M-sample filter history from block to
  block, so back-to-back calls produce the same channel samples as one
  call on the concatenated stream (after the same zero history).
- **Sharded** (:func:`sharded_channelize`): one long capture laid out
  across the "blk" mesh axis, one block a rank; the history arrives from
  the left neighbour by a halo exchange (:mod:`..parallel.halo`) instead
  of a carry. The ranks' frames, concatenated, are the sequential ones.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from radio_mapper_tpu_torch.ops import channelizer as pfb
from radio_mapper_tpu_torch.parallel.halo import with_left_halo
from radio_mapper_tpu_torch.parallel.mesh import MeshAxis


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


def sharded_channelize(
    x_local: torch.Tensor,
    num_channels: int,
    *,
    sample_rate_hz: float,
    taps_per_channel: int = 8,
    block_axis: MeshAxis,
) -> pfb.ChannelizedStream:
    """Rank-local overlap-save channelization (every rank of
    ``block_axis`` calls it with its block).

    ``x_local``: this rank's complex ``[..., L]`` slice of a stream sharded
    on the last axis over ``block_axis`` ("blk"). The (T−1)·M-sample
    history comes from the left neighbour by one halo exchange; shard 0
    sees zeros (the stream-start transient), matching
    :class:`StreamingChannelizer`'s initial state. Output frames
    concatenated across ranks equal the sequential output.
    """
    m = num_channels
    history = (taps_per_channel - 1) * m
    if x_local.shape[-1] % m != 0:
        raise ValueError(f"shard length {x_local.shape[-1]} not a multiple of {m}")
    ext = with_left_halo(x_local.to(torch.complex64), block_axis, history)
    return pfb.channelize(
        ext, m, sample_rate_hz=sample_rate_hz, taps_per_channel=taps_per_channel
    )
