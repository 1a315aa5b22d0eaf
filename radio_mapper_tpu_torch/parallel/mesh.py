"""Meshes of ranks, their axes, and the block of a global array a rank holds.

Port of ``radio_mapper_tpu/parallel/mesh.py``. The JAX package lays one
``jax.sharding.Mesh`` over the devices of one process and places global
arrays with ``NamedSharding``; here each rank is a process
(:mod:`.launch`), the mesh is a ``torch.distributed`` ``DeviceMesh`` over
the ranks, and a "sharding" is a spec — one mesh axis name or None per
array dimension, as ``PartitionSpec`` — that cuts a global array into the
rank's block (:func:`local_block`) and gathers blocks back
(:func:`gather_global`). The axes keep the JAX names: "ch" (channels),
"blk" (time blocks), "pair" (receiver pairs), "sub" (subchannels).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from radio_mapper_tpu_torch.parallel import collectives

DEFAULT_AXES = ("ch", "blk")

Spec = Tuple[Optional[str], ...]  # one mesh axis name (or None) per array dim


class MeshAxis(NamedTuple):
    """One axis of a mesh as a rank sees it: the process group of the ranks
    that differ only along it, their count and this rank's place."""

    name: str
    group: dist.ProcessGroup
    size: int
    index: int


def balanced_mesh_shape(n: int) -> Tuple[int, int]:
    """Factor n into (a, b), a·b = n, as square as possible, a ≤ b."""
    a = int(n**0.5)
    while a > 1 and n % a != 0:
        a -= 1
    return a, n // a


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = DEFAULT_AXES,
    *,
    device: torch.device | str,
) -> DeviceMesh:
    """A mesh over every rank of the initialised process group, for ranks
    on ``device`` (its type: "cuda" or "cpu").

    Default: a 2-D ("ch", "blk") mesh of near-square shape, else one axis
    over every rank. Rank r sits at ``np.unravel_index(r, shape)``.
    """
    n = dist.get_world_size()
    if shape is None:
        shape = balanced_mesh_shape(n) if len(axis_names) == 2 else (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} ranks")
    return init_device_mesh(
        torch.device(device).type, tuple(shape), mesh_dim_names=tuple(axis_names)
    )


def axis(mesh: DeviceMesh, name: str) -> MeshAxis:
    """The axis ``name`` of ``mesh`` as this rank sees it."""
    group = mesh.get_group(name)
    return MeshAxis(name, group, dist.get_world_size(group), mesh.get_local_rank(name))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device of this rank's blocks: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shape(mesh: DeviceMesh) -> dict:
    """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def channel_sharding(ndim: int, channel_axis: int = 0) -> Spec:
    """Shard one array dim over the "ch" mesh axis, replicate the rest."""
    spec = [None] * ndim
    spec[channel_axis] = "ch"
    return tuple(spec)


def time_sharding(ndim: int, time_axis: int = -1) -> Spec:
    """Shard the time/sample dim over the "blk" mesh axis."""
    spec = [None] * ndim
    spec[time_axis % ndim] = "blk"
    return tuple(spec)


def replicated() -> Spec:
    """Every rank holds the whole array."""
    return ()


def local_block(x, mesh: DeviceMesh, spec: Spec):
    """This rank's block of the global array ``x`` (numpy or tensor) under
    ``spec``: each dim named in ``spec`` is cut into equal parts along its
    mesh axis, in the axis's rank order. A dim that does not divide raises,
    as ``jax.device_put`` does."""
    index = [slice(None)] * x.ndim
    for dim, name in enumerate(spec):
        if name is None:
            continue
        ax = axis(mesh, name)
        if x.shape[dim] % ax.size:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide over {ax.size} ranks of {name!r}")
        step = x.shape[dim] // ax.size
        index[dim] = slice(ax.index * step, (ax.index + 1) * step)
    return x[tuple(index)]


def gather_global(x_local: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> torch.Tensor:
    """The global array on every rank from each rank's block under ``spec``:
    one tiled all_gather along each sharded dim (the inverse of
    :func:`local_block`)."""
    out = x_local
    for dim, name in enumerate(spec):
        if name is not None:
            out = collectives.all_gather(out, axis(mesh, name), dim=dim)
    return out
