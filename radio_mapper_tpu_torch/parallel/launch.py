"""Start the ranks of a multi-rank run and collect what each returns.

No JAX counterpart: the JAX package runs one SPMD program over the
devices of one process (``shard_map``). Here a rank is a process with its
own device and its own shard, and the ranks talk through
``torch.distributed``.

:func:`run_ranks` spawns one process a rank (the ``spawn`` start method,
so a rank starts from a fresh import and never inherits a CUDA context),
wires them into one process group through a file store in a private
temporary directory (no TCP port: fixed ports clash when test files run in
parallel), calls ``fn(ctx, *args)`` in each rank and returns every rank's
result, tensors turned into numpy arrays. A rank that raises makes
:func:`run_ranks` raise with that rank's traceback, after it has stopped
every other rank.

Devices: a CPU rank runs its body at one intra-op thread
(:func:`radio_mapper_tpu_torch.device.cpu_single_thread`, fault F2); a
CUDA rank takes card ``rank % device_count``. The backend is gloo on the
CPU and NCCL on the card, except where there are more ranks than cards:
NCCL refuses two ranks on one card, so they take gloo, which carries CUDA
tensors through host memory. Two ranks on one card share its SMs and its
memory: their times are not a multi-card measurement.

The CUDA kernels are built once in the parent before any rank starts
(:func:`radio_mapper_tpu_torch.ops.cuda.build.library` serialises builds
only within one process); every rank then loads the built library.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
import traceback
from multiprocessing import connection
from typing import Any, Callable, List, Sequence

import torch

DEFAULT_TIMEOUT_S = 900.0


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What a rank's body is told about itself."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


class RankFailed(RuntimeError):
    """A rank raised, died or ran past the time limit."""


def default_backend(device_type: str, world_size: int) -> str:
    """gloo on the CPU; NCCL on the card unless there are more ranks than
    cards (NCCL takes one rank a card), then gloo."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def to_numpy(x: Any) -> Any:
    """``x`` with every tensor (in tuples, NamedTuples, lists and dicts)
    copied to a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


def run_ranks(
    fn: Callable[..., Any],
    world_size: int,
    *,
    device: str = "cuda",
    backend: str | None = None,
    args: Sequence[Any] = (),
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> List[Any]:
    """Run ``fn(ctx, *args)`` in ``world_size`` spawned ranks; return their
    results in rank order, tensors as numpy arrays.

    ``fn`` and ``args`` are pickled: ``fn`` must be a module-level function
    of an importable module. ``device`` is "cuda" (the default: the card;
    raises without one) or "cpu". ``backend`` defaults to
    :func:`default_backend`.
    """
    from radio_mapper_tpu_torch import device as device_mod
    from radio_mapper_tpu_torch.ops.cuda import build

    if world_size < 1:
        raise ValueError(f"world_size must be ≥ 1, got {world_size}")
    device_type = torch.device(device).type
    if device_type == "cuda":
        device_mod.require_cuda()
        build.library()  # once, here: the ranks load it
    elif device_type != "cpu":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device!r}")
    backend = backend or default_backend(device_type, world_size)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rm_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs, conns = [], []
        try:
            for rank in range(world_size):
                recv, send = ctx.Pipe(duplex=False)
                p = ctx.Process(
                    target=_rank_main,
                    args=(fn, rank, world_size, device_type, backend, store, tuple(args), send),
                    daemon=True,
                )
                p.start()
                send.close()  # the child holds the only write end: EOF when it exits
                procs.append(p)
                conns.append(recv)
            return _collect(procs, conns, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(10)
            for c in conns:
                c.close()


def _collect(procs, conns, timeout_s: float) -> List[Any]:
    """Every rank's result; raise at the first rank that failed."""
    results: List[Any] = [None] * len(procs)
    pending = dict(enumerate(conns))
    deadline = time.monotonic() + timeout_s
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            raise RankFailed(f"ranks {sorted(pending)} still running after {timeout_s:.0f} s")
        waitables = {c: r for r, c in pending.items()}
        waitables.update({procs[r].sentinel: r for r in pending})
        for obj in connection.wait(list(waitables), timeout=left):
            rank = waitables[obj]
            if rank not in pending:
                continue
            conn = pending[rank]
            if obj is not conn and not conn.poll():
                procs[rank].join(10)
                raise RankFailed(f"rank {rank} exited with code {procs[rank].exitcode} and sent no result")
            try:
                status, payload = conn.recv()
            except EOFError:
                procs[rank].join(10)
                raise RankFailed(f"rank {rank} exited with code {procs[rank].exitcode} and sent no result") from None
            if status != "ok":
                raise RankFailed(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
            del pending[rank]
    return results


def _rank_main(fn, rank, world_size, device_type, backend, store, args, conn) -> None:
    import torch.distributed as dist

    from radio_mapper_tpu_torch import device as device_mod

    try:
        if device_type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        dist.init_process_group(
            backend, init_method=f"file://{store}", world_size=world_size, rank=rank
        )
        ctx = RankContext(rank=rank, world_size=world_size, device=dev, backend=backend)
        if device_type == "cpu":
            with device_mod.cpu_single_thread():
                out = fn(ctx, *args)
        else:
            out = fn(ctx, *args)
            torch.cuda.synchronize(dev)
        msg = ("ok", to_numpy(out))
    except Exception:  # reported to the parent, which stops the other ranks
        conn.send(("error", traceback.format_exc()))
        conn.close()
        return
    dist.destroy_process_group()
    conn.send(msg)
    conn.close()

