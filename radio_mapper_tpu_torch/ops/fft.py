"""Direct DFT of short rows as a matrix product.

Port of the direct branch of ``radio_mapper_tpu/ops/fft.py``
(``_dft_matrix``, ``_dft_direct``), which the reference uses for every
transform of at most ``MAX_DIRECT`` points — here the channelizer's
M-point branch FFT. The reference computes it with XLA dots outside any
Pallas kernel, so ``torch.matmul`` on the same float32 table is the
port. Longer transforms (the four-step matmul FFT and kernel K7) are not
ported (ROADMAP M6).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

MAX_DIRECT = 1024  # the reference's largest direct DFT


@functools.lru_cache(maxsize=None)
def dft_matrix(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(re, im) of the symmetric DFT matrix W[j,k] = exp(-2πi·jk/n), f32."""
    jk = np.outer(np.arange(n), np.arange(n))
    w = np.exp(-2j * np.pi * jk / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dft_on(n: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    w_re, w_im = dft_matrix(n)
    return torch.from_numpy(w_re).to(device), torch.from_numpy(w_im).to(device)


def dft_direct(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward DFT over the last axis of a float32 (re, im) pair, n ≤
    ``MAX_DIRECT``. The products are float32 unless the caller has
    enabled TF32 (``torch.backends.cuda.matmul.allow_tf32``)."""
    n = re.shape[-1]
    if n > MAX_DIRECT:
        raise NotImplementedError(
            f"DFT of {n} > {MAX_DIRECT} points: the four-step FFT is not ported (ROADMAP M6)"
        )
    w_re, w_im = _dft_on(n, re.device)
    return re @ w_re - im @ w_im, re @ w_im + im @ w_re
