"""uint8 interleaved I/Q decode to split (re, im) float32."""

from __future__ import annotations

from typing import Tuple

import torch

from radio_mapper_tpu_torch.constants import UINT8_OFFSET


def decode_uint8_split(raw: torch.Tensor, *, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., 2N]`` uint8 ``I0 Q0 I1 Q1 …`` → ``(re, im)`` float32 ``[..., N]``.

    Same arithmetic as ``split_complex.decode_uint8_split``:
    ``(u8 − 127.5)·scale`` in float32. The outputs are strided views of
    one decoded buffer.
    """
    if raw.shape[-1] % 2 != 0:
        raise ValueError(f"interleaved I/Q length must be even, got {raw.shape[-1]}")
    f = (raw.to(torch.float32) - UINT8_OFFSET) * scale
    d = f.reshape(*f.shape[:-1], f.shape[-1] // 2, 2)
    return d[..., 0], d[..., 1]
