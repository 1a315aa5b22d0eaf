"""The sharded streaming step over a ("ch", "blk") mesh of ranks.

Port of ``radio_mapper_tpu/parallel/sharded.py``:

  DP ("ch")  — wideband channels split across the "ch" axis;
  SP ("blk") — the capture's time axis split across "blk"; the
               channelizer's filter history crosses block edges by a halo
               exchange (:mod:`.halo`);
  pairs      — the all-pairs GCC is a batch axis inside each rank.

Each rank calls the step with its block of the global inputs
(:func:`.mesh.local_block` under ``in_specs``): channelize (with halo) →
per-subchannel all-pairs GCC-PHAT → weighted LM solve. Its outputs are
the rank's block of the global ``[S, C, M, ...]`` arrays, sharded
("blk", "ch") as :data:`OUT_SPEC` says (:func:`.mesh.gather_global`
assembles them).

The split-complex step (:func:`build_sharded_step_split`) routes its pair
stage as the reference does on a TPU mesh: on CUDA ranks the fused chain,
kernel K3 (``fft_rows_ct``) then kernel K2 (``gcc_pair_lag_mags``),
wherever ``gcc_fused_enabled`` holds; on CPU ranks the natural-order
split GCC unless ``split_complex.set_gcc_fused("on")``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from radio_mapper_tpu_torch import solver
from radio_mapper_tpu_torch.models.streaming import sharded_channelize
from radio_mapper_tpu_torch.ops import gcc_phat as gcc_ops
from radio_mapper_tpu_torch.ops import split_complex as sc_ops
from radio_mapper_tpu_torch.parallel import mesh as mesh_lib
from radio_mapper_tpu_torch.parallel.halo import with_left_halo

IN_SPEC = ("ch", None, "blk")  # [C, B, N] inputs
OUT_SPEC = ("blk", "ch")  # [S, C, M, ...] outputs


@dataclasses.dataclass(frozen=True)
class ShardedStepConfig:
    num_channels: int = 4  # wideband channels (sharded over "ch")
    num_buoys: int = 4
    num_subchannels: int = 8  # PFB branches per wideband channel
    taps_per_channel: int = 4
    sample_rate_hz: float = 2_048_000.0
    max_lag: int = 16  # at the sub-channel rate
    solver_iterations: int = 15
    psr_floor: float = 1.1
    psr_scale: float = 2.0

    @property
    def num_pairs(self) -> int:
        return self.num_buoys * (self.num_buoys - 1) // 2


class ShardedStepOutput(NamedTuple):
    fixes_enu: torch.Tensor  # [S, C, M, 3] per time-shard, channel, subchannel
    lags: torch.Tensor  # [S, C, M, P] pair lags (samples @ subchannel rate)
    weights: torch.Tensor  # [S, C, M, P]
    cost: torch.Tensor  # [S, C, M]


def _tail(cfg: ShardedStepConfig, corr, anchors: torch.Tensor) -> ShardedStepOutput:
    """PSR weights + LM solve of one rank's correlations, as its block of
    the global outputs (a leading time-shard axis of 1)."""
    weights = torch.clamp((corr.psr - cfg.psr_floor) / cfg.psr_scale, 0.0, 1.0) + 1e-3
    dd = solver.tau_to_distance_difference(corr.tau_s)
    pair_i, pair_j = gcc_ops.pair_index_tensors(cfg.num_buoys, dd.device)
    res = solver.solve_tdoa(
        anchors.to(torch.float32), pair_i, pair_j, dd, weights, iterations=cfg.solver_iterations
    )
    return ShardedStepOutput(
        fixes_enu=res.position_enu[None],
        lags=corr.lag_samples[None],
        weights=weights[None],
        cost=res.cost[None],
    )


def build_sharded_step(mesh: DeviceMesh, config: ShardedStepConfig):
    """The sharded streaming step for this rank of ``mesh``.

    Returns ``(step_fn, in_specs)`` with
    ``step_fn(x_local, anchors_enu) -> ShardedStepOutput``:

      x_local:     this rank's ``[C/n_ch, B, N/n_blk]`` complex64 block of
                   the global ``[C, B, N]`` (spec ``("ch", None, "blk")``);
      anchors_enu: ``[B, 3]`` float32, replicated.
    """
    cfg = config
    blk = mesh_lib.axis(mesh, "blk")
    sub_rate = cfg.sample_rate_hz / cfg.num_subchannels

    def step(x_local: torch.Tensor, anchors: torch.Tensor) -> ShardedStepOutput:
        chs = sharded_channelize(
            x_local,
            cfg.num_subchannels,
            sample_rate_hz=cfg.sample_rate_hz,
            taps_per_channel=cfg.taps_per_channel,
            block_axis=blk,
        ).channels  # [C_l, B, M, F]
        sub = chs.movedim(1, 2)  # [C_l, M, B, F]
        corr = gcc_ops.gcc_phat_all_pairs(sub, sample_rate_hz=sub_rate, max_lag=cfg.max_lag)
        return _tail(cfg, corr, anchors)

    return step, (IN_SPEC, mesh_lib.replicated())


def sharded_channelize_split(
    re_l: torch.Tensor, im_l: torch.Tensor, config: ShardedStepConfig, blk: mesh_lib.MeshAxis
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split step's channelizer on this rank's ``[C_l, B, N_l]`` block:
    the left neighbour's history prepended (one halo exchange for each
    part), then the PFB. Returns ``(ch_re, ch_im)`` ``[C_l, B, M, F]``."""
    cfg = config
    history = (cfg.taps_per_channel - 1) * cfg.num_subchannels
    return sc_ops.channelize_split(
        with_left_halo(re_l, blk, history),
        with_left_halo(im_l, blk, history),
        cfg.num_subchannels,
        sample_rate_hz=cfg.sample_rate_hz,
        taps_per_channel=cfg.taps_per_channel,
    )


def build_sharded_step_split(mesh: DeviceMesh, config: ShardedStepConfig):
    """Split-complex variant of :func:`build_sharded_step`: inputs are
    (re, im) float32 ``[C, B, N]`` blocks sharded as the complex path's,
    ``step_fn(re_l, im_l, anchors_enu) -> ShardedStepOutput``."""
    cfg = config
    blk = mesh_lib.axis(mesh, "blk")
    sub_rate = cfg.sample_rate_hz / cfg.num_subchannels
    # the fused pair stage on CUDA ranks, as on a TPU mesh; CPU ranks take
    # it only when forced on
    fused_mesh = mesh.device_type == "cuda" or sc_ops.gcc_fused_mode() == "on"

    def step(re_l: torch.Tensor, im_l: torch.Tensor, anchors: torch.Tensor) -> ShardedStepOutput:
        ch_re, ch_im = sharded_channelize_split(re_l, im_l, cfg, blk)  # [C_l, B, M, F]
        sub_re = ch_re.movedim(1, 2)  # [C_l, M, B, F]
        sub_im = ch_im.movedim(1, 2)
        f_len = sub_re.shape[-1]
        gcc_fn = (
            sc_ops.gcc_phat_all_pairs_split_fused
            if fused_mesh and sc_ops.gcc_fused_enabled(f_len + cfg.max_lag, "phat")
            else sc_ops.gcc_phat_all_pairs_split
        )
        corr = gcc_fn(sub_re, sub_im, sample_rate_hz=sub_rate, max_lag=cfg.max_lag)
        return _tail(cfg, corr, anchors)

    return step, (IN_SPEC, IN_SPEC, mesh_lib.replicated())


def global_inputs(config: ShardedStepConfig, n: int, seed: int, split: bool):
    """The JAX package's draws (``sharded.py:205-241``), in its order."""
    cfg = config
    rng = np.random.default_rng(seed)
    shape = (cfg.num_channels, cfg.num_buoys, n)
    if split:
        sig = (rng.normal(size=shape).astype(np.float32), rng.normal(size=shape).astype(np.float32))
    else:
        sig = ((rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64),)
    anchors = rng.normal(scale=5_000.0, size=(cfg.num_buoys, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    return sig, anchors


def _placed(mesh: DeviceMesh, sig, anchors):
    dev = mesh_lib.rank_device(mesh)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (*(to(mesh_lib.local_block(s, mesh, IN_SPEC)) for s in sig), to(anchors))


def example_inputs(mesh: DeviceMesh, config: ShardedStepConfig, *, samples_per_shard: int = 512, seed: int = 0):
    """This rank's ``(x_local, anchors)`` of the global random inputs
    (complex64 ``[C, B, S·samples_per_shard]``), on the rank's device."""
    n = mesh_lib.shape(mesh)["blk"] * samples_per_shard
    return _placed(mesh, *global_inputs(config, n, seed, split=False))


def example_inputs_split(mesh: DeviceMesh, config: ShardedStepConfig, *, samples_per_shard: int = 512, seed: int = 0):
    """This rank's ``(re_l, im_l, anchors)`` float32, no complex dtype."""
    n = mesh_lib.shape(mesh)["blk"] * samples_per_shard
    return _placed(mesh, *global_inputs(config, n, seed, split=True))
