"""Overlap-save halo exchange along a sharded time axis.

Port of ``radio_mapper_tpu/parallel/halo.py``. Continuous DSP over a
time-sharded stream needs each shard to see the tail of its left neighbour
(the channelizer's filter history): one shift of ``halo`` samples over
the "blk" mesh axis (:func:`.collectives.shift`: a send/receive pair on
NCCL, an all_gather of the tails on gloo).

Every function is called by every rank of the axis with its own block,
the time axis last; ``axis`` is the :class:`.mesh.MeshAxis`.
"""

from __future__ import annotations

import torch

from radio_mapper_tpu_torch.parallel import collectives
from radio_mapper_tpu_torch.parallel.mesh import MeshAxis


def left_halo(x: torch.Tensor, axis: MeshAxis, halo: int, *, wrap: bool = False) -> torch.Tensor:
    """Tail (last ``halo`` samples) of the left neighbour's shard.

    Shard 0 receives zeros unless ``wrap`` (matching a zero initial filter
    state at stream start).
    """
    n = axis.size
    idx = axis.index
    tail = x[..., -halo:]
    if n == 1:
        received = torch.zeros_like(tail) if not wrap else tail
        return received
    received = collectives.shift(tail, axis, 1)
    if not wrap and idx == 0:
        received = torch.zeros_like(received)
    return received


def right_halo(x: torch.Tensor, axis: MeshAxis, halo: int, *, wrap: bool = False) -> torch.Tensor:
    """Head (first ``halo`` samples) of the right neighbour's shard."""
    n = axis.size
    idx = axis.index
    head = x[..., :halo]
    if n == 1:
        return head if wrap else torch.zeros_like(head)
    received = collectives.shift(head, axis, -1)
    if not wrap and idx == n - 1:
        received = torch.zeros_like(received)
    return received


def with_left_halo(x: torch.Tensor, axis: MeshAxis, halo: int, *, wrap: bool = False) -> torch.Tensor:
    """Prepend the left neighbour's tail: ``[..., halo + local]``."""
    return torch.cat([left_halo(x, axis, halo, wrap=wrap), x], dim=-1)


def with_right_halo(x: torch.Tensor, axis: MeshAxis, halo: int, *, wrap: bool = False) -> torch.Tensor:
    """Append the right neighbour's head: ``[..., local + halo]``."""
    return torch.cat([x, right_halo(x, axis, halo, wrap=wrap)], dim=-1)
