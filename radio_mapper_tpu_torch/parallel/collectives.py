"""The three collectives of the multi-device layer on ``torch.distributed``.

They stand in for the JAX package's ``jax.lax.all_gather(tiled=True)``,
``jax.lax.psum`` and ``jax.lax.ppermute`` inside ``shard_map``, each over
one mesh axis (:class:`.mesh.MeshAxis`):

- :func:`all_gather`: every rank's block concatenated along a dim, on
  every rank (``dist.all_gather`` into a list);
- :func:`all_reduce`: the sum over the axis, on every rank
  (``dist.all_reduce``);
- :func:`shift`: rank i's tensor arrives at rank (i + offset) mod n. On
  NCCL it is one ``dist.batch_isend_irecv`` pair; on gloo (CPU ranks, and
  two ranks on one card) it is an all_gather of every rank's piece, read
  at the sender's index: the pieces are the halos, (taps − 1)·M samples
  a stream, and gloo has no point-to-point path for CUDA tensors.

Complex tensors travel as their real view. Only calls present in both
torch 2.11 and 2.13 are used.

``counts`` counts the calls of each kind; inside :func:`recording`, each
call's time is also recorded (CUDA events on the card, the host clock on
the CPU) for the caller to read.
"""

from __future__ import annotations

import contextlib
import time
from typing import TYPE_CHECKING, Callable, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from radio_mapper_tpu_torch.parallel.mesh import MeshAxis

counts = {"all_gather": 0, "all_reduce": 0, "shift": 0}


class Recorder:
    """Spans of the collectives called while it records, by kind."""

    def __init__(self):
        self._spans: Dict[str, List] = {k: [] for k in counts}

    def time(self, kind: str, device: torch.device, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            self._spans[kind].append((start, stop))
        else:
            t0 = time.perf_counter()
            out = fn()
            self._spans[kind].append(1e3 * (time.perf_counter() - t0))
        return out

    def ms(self) -> Dict[str, float]:
        """Total milliseconds of each kind (waits for the card)."""
        total = {}
        for kind, spans in self._spans.items():
            ms = 0.0
            for s in spans:
                if isinstance(s, tuple):
                    s[1].synchronize()
                    s = s[0].elapsed_time(s[1])
                ms += s
            total[kind] = ms
        return total

    def calls(self) -> Dict[str, int]:
        return {k: len(v) for k, v in self._spans.items()}


_recorder: Optional[Recorder] = None


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record the time of every collective called in the body."""
    global _recorder
    prev, _recorder = _recorder, Recorder()
    try:
        yield _recorder
    finally:
        _recorder = prev


def _run(kind: str, x: torch.Tensor, fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    counts[kind] += 1
    if _recorder is None:
        return fn()
    return _recorder.time(kind, x.device, fn)


def all_gather(x: torch.Tensor, ax: MeshAxis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``ax``, concatenated in rank order along
    ``dim`` (``jax.lax.all_gather(x, axis, tiled=True)``, there on axis 0)."""
    dim = dim % x.dim()
    if x.is_complex():
        return torch.view_as_complex(all_gather(torch.view_as_real(x), ax, dim))

    def run():
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        dist.all_gather(parts, x.contiguous(), group=ax.group)
        return torch.cat(parts, dim=dim)

    return _run("all_gather", x, run)


def all_reduce(x: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``ax``, on each of them
    (``jax.lax.psum``); ``x`` is left as it was."""
    if x.is_complex():
        return torch.view_as_complex(all_reduce(torch.view_as_real(x), ax))

    def run():
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ax.group)
        return out

    return _run("all_reduce", x, run)


def psum(ax: MeshAxis) -> Callable[[torch.Tensor], torch.Tensor]:
    """:func:`all_reduce` over ``ax`` as a one-argument callable (the
    solver's ``psum``)."""
    return lambda x: all_reduce(x, ax)


def shift(x: torch.Tensor, ax: MeshAxis, offset: int) -> torch.Tensor:
    """What rank (i − offset) mod n of ``ax`` holds, on rank i: every
    rank's ``x`` moves ``offset`` places along the axis, wrapping
    (``jax.lax.ppermute`` with the pairs (i, (i + offset) mod n))."""
    n, i = ax.size, ax.index
    if x.is_complex():
        return torch.view_as_complex(shift(torch.view_as_real(x), ax, offset))
    src = (i - offset) % n
    if dist.get_backend(ax.group) != "nccl":
        # gloo: the pieces through one all_gather (counted as one)
        return all_gather(x.unsqueeze(0), ax, dim=0)[src]

    def run():
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        peer = lambda r: dist.get_global_rank(ax.group, r)
        ops = [
            dist.P2POp(dist.isend, x.contiguous(), peer((i + offset) % n), group=ax.group),
            dist.P2POp(dist.irecv, out, peer(src), group=ax.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    return _run("shift", x, run)
