"""The ingest-closed loop: native ring → pinned host slot → device → step.

Port of ``radio_mapper_tpu/ingest/runner.py`` (``IngestLoop``,
``IngestLoopStats``). A producer thread fills the ring at the SDR's pace
(``native/ingest.cpp``); the loop drains fixed blocks of raw uint8 I/Q
and hands them to a step that decodes them on the device (2 bytes a
sample cross the bus instead of 8 for split float32):

    ring → read_into a pinned slot (host)      ingest.native.NativeIngest
      → non_blocking copy on a side stream     torch.cuda.Stream, an event
      → the step on the compute stream         TDOAPipeline.step_split_uint8
        (it waits on the copy's event)           (K1 → K2 on the card)
      → one completion barrier after the last  device.completion_barrier

The port's step is eager and blocks the host in its LM solve, so the
reference's order (dispatch step k, then read block k+1) would serialize
read, copy and compute. Here block k+1 is read and its copy issued
*before* step k is called: the copy then runs on the side stream under
step k's kernels. Two pinned slots rotate (:class:`SlotRing`); a slot is
drained again only after its copy's event has completed, so a pending
copy never reads bytes the ring is overwriting.

Drop accounting is the ring's own (``stats()``): with a paced source,
``dropped_bytes == 0`` after a sustained run is the real-time criterion.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch.device import completion_barrier


@dataclasses.dataclass
class IngestLoopStats:
    steps: int
    samples_per_step: int
    elapsed_s: float
    sustained_samples_per_s: float
    host_read_ms_per_step: float  # ring drain into the slot (host)
    transfer_ms_per_step: float  # issuing the host → device copy (host)
    real_time_ratio: float  # sustained rate / source rate (>= 1 keeps up)
    dropped_bytes: int  # ring-overflow BYTES (2 bytes = one I/Q sample)
    bytes_consumed: int

    @property
    def dropped_samples(self) -> int:
        """Ring-overflow complex samples (uint8 I/Q: 2 bytes a sample)."""
        return self.dropped_bytes // 2

    @property
    def drops(self) -> int:  # the reference's older name (bytes)
        return self.dropped_bytes


class SlotRing:
    """Two host slots in rotation, each guarded by the event of its last
    copy: one slot is drained while the other's copy is in flight.

    :meth:`acquire` hands out the next slot as a writable numpy view, after
    waiting (``stop.synchronize()``) for the copy that last read it;
    :meth:`release` records the events around the slot's new copy. ``pin``
    allocates page-locked memory (what makes a ``non_blocking`` copy truly
    asynchronous, and a slot reused too early corrupt the block in flight).
    A copy released with a timing ``start`` event adds its CUDA-event time
    to ``copy_ms`` and one to ``copies`` once it has been waited on.
    """

    def __init__(self, nbytes: int, *, pin: bool = False):
        self.host = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin) for _ in range(2)]
        self.pending: List[Optional[Tuple[object, object]]] = [None, None]  # (start, stop)
        self.next = 0
        self.copy_ms, self.copies = 0.0, 0

    def _wait(self, k: int) -> None:
        if self.pending[k] is None:
            return
        start, stop = self.pending[k]
        stop.synchronize()
        self.pending[k] = None
        if start is not None:
            self.copy_ms += start.elapsed_time(stop)
            self.copies += 1

    def acquire(self) -> Tuple[int, np.ndarray]:
        k = self.next
        self.next = 1 - k
        self._wait(k)
        return k, self.host[k].numpy()

    def release(self, k: int, stop, start=None) -> None:
        self.pending[k] = (start, stop)

    def settle(self) -> None:
        """Wait for both slots' copies (and count their time)."""
        self._wait(0)
        self._wait(1)


class IngestLoop:
    """Drive a step from a native ring with double buffering.

    Args:
      step: ``(raw_u8 [ch, B, 2N], anchors) -> output`` on ``device``, for
        example ``TDOAPipeline.step_split_uint8`` (or, with
        ``blocks_per_dispatch > 1``, ``step_split_uint8_scan`` on
        ``[k, ch, B, 2N]``); :meth:`from_pipeline` picks it.
      ingest: a :class:`~radio_mapper_tpu_torch.ingest.native.NativeIngest`,
        or any object with ``read_into`` or ``read_bytes`` and ``stats()``.
      channels, num_buoys, block_len: the block; one read is
        ``blocks_per_dispatch · channels · num_buoys · 2 · block_len`` bytes.
      anchors: anchors on ``device``, passed to every step.
      source_samples_per_s: the source's aggregate complex-sample rate (for
        the real-time ratio); 0 disables the ratio.
      device: where the step runs ("cuda" by default). The blocks go
        through two host slots in rotation: pinned, with a side stream for
        the copies, on a CUDA device; on the CPU the step reads the slot
        itself (it is done before the slot is drained again).
      drain_threads: > 1 runs the ring → slot memcpy as the parallel C++
        drain.
    """

    def __init__(
        self,
        step: Callable,
        ingest,
        *,
        channels: int,
        num_buoys: int,
        block_len: int,
        anchors: torch.Tensor,
        source_samples_per_s: float = 0.0,
        device: torch.device | str = "cuda",
        blocks_per_dispatch: int = 1,
        drain_threads: int = 0,
    ):
        self.step = step
        self.ingest = ingest
        self.channels = channels
        self.num_buoys = num_buoys
        self.block_len = block_len
        self.anchors = anchors
        self.source_samples_per_s = source_samples_per_s
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.blocks_per_dispatch = int(blocks_per_dispatch)
        self.block_bytes = self.blocks_per_dispatch * channels * num_buoys * 2 * block_len
        self.drain_threads = int(drain_threads)
        cuda = dev.type == "cuda"
        self._slots = SlotRing(self.block_bytes, pin=cuda)
        self._copy_stream = torch.cuda.Stream(dev) if cuda else None

    @classmethod
    def from_pipeline(cls, pipeline, ingest, *, channels: int, anchors: torch.Tensor,
                      blocks_per_dispatch: int = 1, **kw) -> "IngestLoop":
        """A loop over a ``TDOAPipeline``: its device, its block geometry
        (a block is ``correlation_dwells · block_len`` samples a buoy) and
        ``step_split_uint8``, or ``step_split_uint8_scan`` when
        ``blocks_per_dispatch > 1``."""
        c = pipeline.config
        step = pipeline.step_split_uint8_scan if blocks_per_dispatch > 1 else pipeline.step_split_uint8
        return cls(step, ingest, channels=channels, num_buoys=c.num_buoys,
                   block_len=c.correlation_dwells * c.block_len, anchors=anchors,
                   device=pipeline.device, blocks_per_dispatch=blocks_per_dispatch, **kw)

    def _block_shape(self):
        base = (self.channels, self.num_buoys, 2 * self.block_len)
        if self.blocks_per_dispatch > 1:
            return (self.blocks_per_dispatch, *base)
        return base

    def _read_block(self, timeout_ms: int = 10_000) -> Tuple[int, np.ndarray]:
        """Drain one block from the ring into the next slot: ``(slot,
        bytes)``."""
        k, buf = self._slots.acquire()
        if hasattr(self.ingest, "read_into"):
            got, _ts = self.ingest.read_into(buf, timeout_ms, threads=self.drain_threads)
        else:  # pure-Python sources
            raw, _ts = self.ingest.read_bytes(self.block_bytes, timeout_ms)
            got = raw.size
            buf[:got] = raw
        if got < self.block_bytes:
            raise IOError(
                f"ring underrun: wanted {self.block_bytes} got {got} "
                "(source stalled or timeout too small)"
            )
        return k, buf

    def _stage(self, k: int, buf: np.ndarray):
        """Issue the block's move to the device: ``(tensor, copy event)``.

        On a CUDA device the copy runs on the side stream from the pinned
        slot; its end event guards the slot (:class:`SlotRing`) and tells
        the compute stream when the block is there. On the CPU the tensor
        is the slot itself."""
        shape = self._block_shape()
        if self._copy_stream is None:
            return torch.from_numpy(buf.reshape(shape)), None
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty(shape, dtype=torch.uint8, device=self.device)
            start.record()  # after the allocation: the events time the copy alone
            dev.copy_(self._slots.host[k].view(shape), non_blocking=True)
            stop.record()
        self._slots.release(k, stop, start)
        return dev, stop

    def _launch(self, staged):
        raw, ready = staged
        if ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(ready)
            raw.record_stream(compute)  # allocated on the side stream, read on this one
        return self.step(raw, self.anchors)

    def warm_compile(self, seed: int = 0):
        """Run the step once on a random block (no ring read): the kernels'
        build and the first launches land outside a timed run. Call it
        before opening a paced source, or the build fills the ring."""
        k, buf = self._slots.acquire()
        buf[:] = np.random.default_rng(seed).integers(0, 256, size=self.block_bytes, dtype=np.uint8)
        self._launch(self._stage(k, buf))
        completion_barrier(self.device)

    def copy_ms_per_step(self) -> Optional[float]:
        """Mean CUDA-event time of the host → device copies of the last
        :meth:`run` (the copy itself, on the side stream); ``None`` on the
        CPU."""
        s = self._slots
        return s.copy_ms / s.copies if s.copies else None

    def run(self, num_steps: int, *, warmup_steps: int = 1) -> IngestLoopStats:
        """Run the overlap loop; returns sustained-throughput stats.

        The timed window starts after the warm-up steps have finished and
        closes at one completion barrier after the last step. With a paced
        source, call :meth:`warm_compile` first and pass ``warmup_steps=0``
        so the warm-up does not fill the ring."""
        for _ in range(warmup_steps):
            self._launch(self._stage(*self._read_block()))
        completion_barrier(self.device)
        self._slots.settle()
        self._slots.copy_ms, self._slots.copies = 0.0, 0

        host_ms = 0.0
        put_ms = 0.0

        def next_block():
            nonlocal host_ms, put_ms
            th = time.perf_counter()
            k, buf = self._read_block()
            tp = time.perf_counter()
            staged = self._stage(k, buf)
            host_ms += (tp - th) * 1e3
            put_ms += (time.perf_counter() - tp) * 1e3
            return staged

        t0 = time.perf_counter()
        staged = next_block()
        for k in range(num_steps):
            cur = staged
            if k + 1 < num_steps:
                staged = next_block()  # block k+1 read and its copy issued before step k
            self._launch(cur)
        completion_barrier(self.device)
        elapsed = time.perf_counter() - t0
        self._slots.settle()

        samples_per_step = self.blocks_per_dispatch * self.channels * self.num_buoys * self.block_len
        sustained = samples_per_step * num_steps / elapsed
        stats = self.ingest.stats()
        return IngestLoopStats(
            steps=num_steps,
            samples_per_step=samples_per_step,
            elapsed_s=elapsed,
            sustained_samples_per_s=sustained,
            host_read_ms_per_step=host_ms / num_steps,
            transfer_ms_per_step=put_ms / num_steps,
            real_time_ratio=sustained / self.source_samples_per_s if self.source_samples_per_s else 0.0,
            dropped_bytes=int(stats["bytes_dropped"]),
            bytes_consumed=int(stats["bytes_consumed"]),
        )
