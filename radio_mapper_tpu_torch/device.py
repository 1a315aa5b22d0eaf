"""The CUDA card the port runs on, and a check that one is present."""

from __future__ import annotations

import dataclasses
import shutil
import subprocess

import torch


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
