"""Rank bodies of the multi-device layer, for :func:`.launch.run_ranks`.

Each job takes the rank's :class:`.launch.RankContext` and global numpy
inputs (every rank gets the same), builds its mesh, takes this rank's
block, runs one piece of the layer and returns numpy results: the global
outputs, gathered on the rank, or the rank's own. :func:`run_jobs` runs a
list of them in one launch, so a caller pays the ranks' start-up once.
The CPU tests and the card tests (``tests/test_torch_cuda.py -k
parallel``) call these.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch import solver
from radio_mapper_tpu_torch.models import streaming
from radio_mapper_tpu_torch.models import wideband as wb
from radio_mapper_tpu_torch.ops import split_complex as sc_ops
from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.parallel import collectives, halo
from radio_mapper_tpu_torch.parallel import mesh as mesh_lib
from radio_mapper_tpu_torch.parallel import pair_ep, sharded
from radio_mapper_tpu_torch.parallel.launch import RankContext

Job = Tuple[Callable[..., Any], Dict[str, Any]]


def run_jobs(ctx: RankContext, jobs: Sequence[Job]) -> List[Any]:
    """``[fn(ctx, **kwargs) for fn, kwargs in jobs]``, in order."""
    return [fn(ctx, **kwargs) for fn, kwargs in jobs]


def _to(ctx: RankContext, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)


def _gather(out, mesh, specs):
    """A NamedTuple of rank blocks → the global arrays, field by field."""
    return type(out)(*(mesh_lib.gather_global(x, mesh, s) for x, s in zip(out, specs)))


def halos(ctx: RankContext, x: np.ndarray, halo_len: int, mesh_shape: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Every halo of this rank's block of ``x``, its last axis sharded over
    "blk" of a ("ch", "blk") mesh of ``mesh_shape``."""
    mesh = mesh_lib.make_mesh(mesh_shape, device=ctx.device.type)
    ax = mesh_lib.axis(mesh, "blk")
    x_l = _to(ctx, mesh_lib.local_block(x, mesh, mesh_lib.time_sharding(x.ndim)))
    out = {}
    for wrap in (False, True):
        for name, fn in (("left", halo.left_halo), ("right", halo.right_halo),
                         ("with_left", halo.with_left_halo), ("with_right", halo.with_right_halo)):
            out[f"{name}{'_wrap' if wrap else ''}"] = fn(x_l, ax, halo_len, wrap=wrap)
    return out


def channelize(ctx: RankContext, x: np.ndarray, num_channels: int, *, sample_rate_hz: float,
               taps_per_channel: int) -> np.ndarray:
    """``sharded_channelize`` of complex ``x [..., N]`` split over "blk"
    (one axis over every rank), frames gathered: ``[..., M, N/M]``."""
    mesh = mesh_lib.make_mesh((ctx.world_size,), ("blk",), device=ctx.device.type)
    ax = mesh_lib.axis(mesh, "blk")
    x_l = _to(ctx, mesh_lib.local_block(x, mesh, mesh_lib.time_sharding(x.ndim)))
    ch = streaming.sharded_channelize(
        x_l, num_channels, sample_rate_hz=sample_rate_hz, taps_per_channel=taps_per_channel, block_axis=ax,
    ).channels
    return collectives.all_gather(ch, ax, dim=-1)


def sharded_step(ctx: RankContext, config: sharded.ShardedStepConfig, x: Sequence[np.ndarray],
                 anchors: np.ndarray, mesh_shape: Tuple[int, int], split: bool, fused: str = "auto"):
    """The sharded step (complex ``x = (wideband,)`` or split ``x = (re,
    im)``, global ``[C, B, N]``) on a ("ch", "blk") mesh, its outputs
    gathered to the global ``[S, C, M, ...]``. ``fused`` sets
    ``split_complex.set_gcc_fused`` for the call."""
    mesh = mesh_lib.make_mesh(mesh_shape, device=ctx.device.type)
    build = sharded.build_sharded_step_split if split else sharded.build_sharded_step
    prev = sc_ops.gcc_fused_mode()
    sc_ops.set_gcc_fused(fused)
    try:
        step, specs = build(mesh, config)
        blocks = [_to(ctx, mesh_lib.local_block(a, mesh, s)) for a, s in zip((*x, anchors), specs)]
        out = step(*blocks)
    finally:
        sc_ops.set_gcc_fused(prev)
    return _gather(out, mesh, [sharded.OUT_SPEC] * 4)


def ep_solve(ctx: RankContext, anchors, pair_i, pair_j, dd, weights, iterations: int) -> np.ndarray:
    """The psum'd LM solve with the (padded) pair axis split over every
    rank: this rank's fix."""
    mesh = mesh_lib.make_mesh((ctx.world_size,), ("pair",), device=ctx.device.type)
    ax = mesh_lib.axis(mesh, "pair")
    spec = ("pair",)
    res = solver.solve_tdoa(
        _to(ctx, anchors),
        *(_to(ctx, mesh_lib.local_block(np.asarray(a), mesh, spec)) for a in (pair_i, pair_j, dd, weights)),
        iterations=iterations, psum=collectives.psum(ax),
    )
    return res.position_enu


def ep_step(ctx: RankContext, config: pair_ep.PairEPConfig, re: np.ndarray, im: np.ndarray,
            anchors: np.ndarray, fused: str = "auto") -> pair_ep.PairEPOutput:
    """The EP step over one "pair" axis of every rank: its output with the
    pair fields gathered (``[P_pad]``); fix, cost and ellipse are this
    rank's own (identical on every rank when the psum holds)."""
    mesh = mesh_lib.make_mesh((ctx.world_size,), ("pair",), device=ctx.device.type)
    prev = sc_ops.gcc_fused_mode()
    sc_ops.set_gcc_fused(fused)
    try:
        step, specs, _ = pair_ep.build_pair_ep_step(mesh, config)
        out = step(*(_to(ctx, mesh_lib.local_block(a, mesh, s)) for a, s in zip((re, im, anchors), specs)))
    finally:
        sc_ops.set_gcc_fused(prev)
    return _gather(out, mesh, pair_ep.OUT_SPEC)


def wideband_sharded(ctx: RankContext, config: wb.WidebandConfig, re: np.ndarray, im: np.ndarray,
                     anchors: np.ndarray, onehot: str = "auto", fused: str = "auto") -> wb.WidebandOutput:
    """``build_wideband_sharded_step`` over one "sub" axis of every rank;
    ``onehot`` sets ``gcc_pair.set_onehot_pairs`` (K5 "on", K6 "off") and
    ``fused`` ``split_complex.set_gcc_fused`` ("off": the natural-grid
    fallback) while the step is built and run."""
    mesh = mesh_lib.make_mesh((ctx.world_size,), ("sub",), device=ctx.device.type)
    prev = sc_ops.gcc_fused_mode()
    gcc_pair.set_onehot_pairs(onehot)
    sc_ops.set_gcc_fused(fused)
    try:
        step, _ = wb.build_wideband_sharded_step(mesh, config)
        return step(_to(ctx, re), _to(ctx, im), _to(ctx, anchors))
    finally:
        sc_ops.set_gcc_fused(prev)
        gcc_pair.set_onehot_pairs("auto")
