"""The CUDA card the port runs on, a check that one is present, the
thread count of the kernels' plain versions on the CPU, and the barrier
that closes a timed run of queued device work."""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import subprocess
from typing import Iterator

import torch


def completion_barrier(device: torch.device) -> None:
    """Wait until the work queued on ``device``'s current stream has
    finished.

    Replaces the reference's ``utils/device.force_fetch`` (one host fetch
    of a value derived from every output): on a CUDA device a CUDA event is
    recorded on the current stream, after the last queued step, and
    synchronized; on the CPU the work is already done and this is a no-op.
    """
    if device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        ev.synchronize()


@contextlib.contextmanager
def cpu_single_thread() -> Iterator[None]:
    """Run the body at one PyTorch intra-op thread; restore the caller's
    count on exit, on an exception too.

    Every kernel wrapper runs its plain version inside this on the CPU
    (fault F2): with two intra-op threads, PyTorch's CPU build on an
    AMX-capable Xeon returned a wrong result from the first plain K5 call
    (``gcc_pairs_onehot_lag_mags``) of 3 in 96 fresh processes, 18 in 96
    after a one-thread warm-up product and 5 in 96 with oneDNN disabled,
    each off by the same 1.856e-4 of the global max; none in 96 with
    ``MKL_ENABLE_INSTRUCTIONS=AVX2`` and none in 256 at one thread. The
    fault is MKL's AVX-512/AMX float32 product on more than one thread.
    """
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


@dataclasses.dataclass(frozen=True)
class CardInfo:
    """What a measurement names beside its numbers."""

    name: str  # torch.cuda.get_device_name(0)
    count: int  # torch.cuda.device_count()
    smi: str  # `nvidia-smi --query-gpu=name,power.limit` line of card 0

    def label(self) -> str:
        return f"[{self.smi}]"


def require_cuda() -> CardInfo:
    """Return the card's name and power limit; raise if there is no card.

    The power limit comes from ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (a card capped below its maximum runs slower
    under load, so every time the port reports carries it).
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda})"
        )
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found: cannot read the card's power limit")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    return CardInfo(
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        smi=out[0].strip(),
    )
