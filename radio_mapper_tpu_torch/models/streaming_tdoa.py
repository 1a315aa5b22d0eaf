"""Continuous streaming TDOA: channelize → correlate → solve, with state.

Port of ``radio_mapper_tpu/models/streaming_tdoa.py`` (BASELINE config 3:
8 buoys × 16 subchannels, overlap-save streaming). Each ``step`` takes
one multi-buoy complex block, advances the channelizer's state
(:mod:`.streaming`), correlates every buoy pair in every subchannel
(:func:`..ops.gcc_phat.gcc_phat_all_pairs`: at the default shape 1024
frames, nfft 1080, the matmul four-step) and solves a position per
subchannel. ``scan`` is a Python loop over the blocks that carries the
state; outputs stack on a leading block axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch import solver
from radio_mapper_tpu_torch.models.streaming import ChannelizerState, StreamingChannelizer
from radio_mapper_tpu_torch.ops import gcc_phat as gcc_ops


@dataclasses.dataclass(frozen=True)
class StreamingTDOAConfig:
    """Static configuration (the same fields and defaults as the JAX package's)."""

    num_buoys: int = 8
    num_subchannels: int = 16
    taps_per_channel: int = 8
    sample_rate_hz: float = 2_400_000.0
    block_len: int = 16_384  # per step, per buoy (multiple of subchannels)
    max_lag: int = 32  # at the sub-channel rate
    weighting: str = "phat"
    solver_iterations: int = 20
    psr_floor: float = 1.1
    psr_scale: float = 2.0

    @property
    def num_pairs(self) -> int:
        return self.num_buoys * (self.num_buoys - 1) // 2

    @property
    def subchannel_rate_hz(self) -> float:
        return self.sample_rate_hz / self.num_subchannels


class StreamingStepOutput(NamedTuple):
    fixes_enu: torch.Tensor  # [M, 3]
    lags: torch.Tensor  # [M, P] sub-channel-rate samples
    psr: torch.Tensor  # [M, P]
    weights: torch.Tensor  # [M, P]
    cost: torch.Tensor  # [M]
    # per-subchannel 1σ horizontal error ellipse (solver covariance)
    ellipse_major_m: torch.Tensor  # [M]
    ellipse_minor_m: torch.Tensor  # [M]
    ellipse_orientation_deg: torch.Tensor  # [M]


class StreamingTDOA:
    """The streaming model on one device (the card by default; CPU callers
    pass ``device="cpu"``). Inputs must already lie on that device."""

    def __init__(self, config: StreamingTDOAConfig, *, device: torch.device | str = "cuda"):
        self.config = config
        if config.block_len % config.num_subchannels:
            raise ValueError("block_len must be a multiple of num_subchannels")
        self.device = torch.device(device)
        self.channelizer = StreamingChannelizer(
            config.num_subchannels,
            sample_rate_hz=config.sample_rate_hz,
            taps_per_channel=config.taps_per_channel,
            device=self.device,
        )
        self.pair_i, self.pair_j = gcc_ops.pair_index_tensors(config.num_buoys, self.device)

    def init_state(self) -> ChannelizerState:
        return self.channelizer.init_state((self.config.num_buoys,))

    def step(
        self,
        state: ChannelizerState,
        block: torch.Tensor,  # [B, L] complex64
        anchors_enu: torch.Tensor,  # [B, 3]
    ) -> Tuple[ChannelizerState, StreamingStepOutput]:
        cfg = self.config
        for x in (state.tail, block, anchors_enu):
            if x.device != self.device:
                raise ValueError(f"input on {x.device}, model on {self.device}")
        state, chs = self.channelizer.step(state, block)
        sub = chs.channels.movedim(0, 1)  # [M, B, F]
        corr = gcc_ops.gcc_phat_all_pairs(
            sub, sample_rate_hz=cfg.subchannel_rate_hz, max_lag=cfg.max_lag, weighting=cfg.weighting
        )
        weights = torch.clamp((corr.psr - cfg.psr_floor) / cfg.psr_scale, 0.0, 1.0) + 1e-3
        res = solver.solve_tdoa(
            anchors_enu,
            self.pair_i,
            self.pair_j,
            solver.tau_to_distance_difference(corr.tau_s),
            weights,
            iterations=cfg.solver_iterations,
        )
        return state, StreamingStepOutput(
            fixes_enu=res.position_enu,
            lags=corr.lag_samples,
            psr=corr.psr,
            weights=weights,
            cost=res.cost,
            ellipse_major_m=res.ellipse_major_m,
            ellipse_minor_m=res.ellipse_minor_m,
            ellipse_orientation_deg=res.ellipse_orientation_deg,
        )

    def scan(
        self,
        blocks: torch.Tensor,  # [T, B, L]
        anchors_enu: torch.Tensor,
        state: Optional[ChannelizerState] = None,
    ) -> Tuple[ChannelizerState, StreamingStepOutput]:
        """:meth:`step` over T consecutive blocks, the state carried from
        one to the next; the outputs stack on a leading T axis."""
        if state is None:
            state = self.init_state()
        outs = []
        for block in blocks.unbind(0):
            state, out = self.step(state, block, anchors_enu)
            outs.append(out)
        return state, StreamingStepOutput(*(torch.stack(f) for f in zip(*outs)))

    def example_inputs(self, *, num_blocks: int = 4, seed: int = 0):
        """Random ``(blocks [T, B, L] complex64, anchors [B, 3])`` on the
        model's device, drawn from numpy ``default_rng(seed)`` in the JAX
        package's order, so both packages see the same values."""
        cfg = self.config
        rng = np.random.default_rng(seed)
        blocks = (
            rng.normal(size=(num_blocks, cfg.num_buoys, cfg.block_len))
            + 1j * rng.normal(size=(num_blocks, cfg.num_buoys, cfg.block_len))
        ).astype(np.complex64)
        anchors = rng.normal(scale=8_000.0, size=(cfg.num_buoys, 3)).astype(np.float32)
        anchors[:, 2] = 0.0
        return torch.from_numpy(blocks).to(self.device), torch.from_numpy(anchors).to(self.device)
