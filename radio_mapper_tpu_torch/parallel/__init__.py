"""Parallelism layer: meshes of ranks, halo exchange, the sharded steps.

Port of ``radio_mapper_tpu/parallel/`` on ``torch.distributed``. The JAX
package runs one SPMD program over a ``jax.sharding.Mesh``; here each rank
is a process with its own device and block (:mod:`.launch`), and the
mesh is a ``DeviceMesh`` over the ranks whose axes keep the JAX names:

  axis "ch"   — channel/buoy-batch data parallelism;
  axis "blk"  — time-block/sequence parallelism with overlap-save halo
                exchange (:mod:`.halo`);
  axis "pair" — the pair-parallel (EP) GCC and solve (:mod:`.pair_ep`);
  axis "sub"  — the wideband step's subchannels
                (``models.wideband.build_wideband_sharded_step``).

Collectives (:mod:`.collectives`) stand in for ``all_gather``, ``psum``
and ``ppermute``.
"""

from radio_mapper_tpu_torch.parallel.mesh import (
    DEFAULT_AXES,
    balanced_mesh_shape,
    make_mesh,
)
from radio_mapper_tpu_torch.parallel.halo import left_halo, with_left_halo
from radio_mapper_tpu_torch.parallel.launch import run_ranks

__all__ = [
    "DEFAULT_AXES",
    "balanced_mesh_shape",
    "make_mesh",
    "left_halo",
    "with_left_halo",
    "run_ranks",
]
