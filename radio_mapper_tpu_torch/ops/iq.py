"""uint8 interleaved I/Q codec: decode to split (re, im) float32 or to
complex64 on any device, encode back, and the host-side (numpy) codec and
``.bin`` capture files of the ingest sources.

Port of ``radio_mapper_tpu/ops/iq.py`` and
``split_complex.decode_uint8_split``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch.constants import UINT8_OFFSET

# Full-scale normalization: ±127.5 maps to ±1.0.
UINT8_SCALE = 1.0 / 127.5


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


def decode_uint8_iq(raw: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """``[..., 2N]`` uint8 ``I0 Q0 I1 Q1 …`` → complex64 ``[..., N]``, the
    same values as :func:`decode_uint8_split` (the reference's
    ``decode_uint8_iq``)."""
    return torch.complex(*decode_uint8_split(raw, scale=scale))


def encode_uint8_iq(iq: torch.Tensor, *, scale: float = 1.0) -> torch.Tensor:
    """Inverse of :func:`decode_uint8_iq`: complex ``[..., N]`` →
    interleaved uint8 ``[..., 2N]``, rounded half to even and saturated to
    [0, 255]."""
    i = iq.real / scale + UINT8_OFFSET
    q = iq.imag / scale + UINT8_OFFSET
    inter = torch.stack([i, q], dim=-1).reshape(*iq.shape[:-1], 2 * iq.shape[-1])
    return torch.clamp(torch.round(inter), 0.0, 255.0).to(torch.uint8)


def encode_uint8_iq_numpy(iq: np.ndarray, *, scale: float = 1.0) -> np.ndarray:
    """Host-side (numpy) encoder for network and file paths."""
    i = np.clip(np.round(np.real(iq) / scale + UINT8_OFFSET), 0, 255)
    q = np.clip(np.round(np.imag(iq) / scale + UINT8_OFFSET), 0, 255)
    out = np.empty((*np.shape(iq)[:-1], 2 * np.shape(iq)[-1]), dtype=np.uint8)
    out[..., 0::2] = i.astype(np.uint8)
    out[..., 1::2] = q.astype(np.uint8)
    return out


def decode_uint8_iq_numpy(raw: np.ndarray, *, scale: float = 1.0) -> np.ndarray:
    """NumPy float64 decode: interleaved bytes → complex128."""
    f = (raw.astype(np.float64) - UINT8_OFFSET) * scale
    return (f[..., 0::2] + 1j * f[..., 1::2]).astype(np.complex128)


def load_iq_bin(path: str, *, scale: float = 1.0) -> np.ndarray:
    """Load a raw ``.bin`` capture (uint8 interleaved I/Q; an odd trailing
    byte is dropped) as complex128."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % 2 != 0:
        raw = raw[:-1]
    return decode_uint8_iq_numpy(raw, scale=scale)


def save_iq_bin(path: str, iq: np.ndarray, *, scale: float = 1.0) -> None:
    """Write complex samples as a raw uint8 interleaved capture file."""
    encode_uint8_iq_numpy(np.ravel(iq), scale=scale).tofile(path)
