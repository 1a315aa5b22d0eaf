"""GCC peak pick: integer argmax → parabolic sub-sample refine → PSR.

Port of the tail of ``radio_mapper_tpu/ops/gcc_phat.py``
(``CorrelationPeak``, ``pair_indices``, ``parabolic_refine``,
``peak_to_sidelobe``, ``peaks_from_lag_mags``) with the lowest-index
argmax of :mod:`.safe`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch.ops import safe


class CorrelationPeak(NamedTuple):
    """Result of a (batched) GCC peak pick; fields are ``[...]`` shaped."""

    lag_samples: torch.Tensor  # float32 — sub-sample lag of x relative to y
    tau_s: torch.Tensor  # float32 — lag / sample_rate
    peak_value: torch.Tensor  # float32 — |r| at the (integer) peak
    psr: torch.Tensor  # float32 — peak-to-sidelobe ratio (quality metric)


def pair_indices(num_receivers: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (i, j) index arrays for all i<j pairs."""
    i, j = np.triu_indices(num_receivers, k=1)
    return i.astype(np.int32), j.astype(np.int32)


def parabolic_refine(m: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Sub-sample offset from the parabola through m[k−1], m[k], m[k+1];
    clamped to (−1, 1), 0 at the window edges or on a degenerate fit."""
    length = m.shape[-1]
    kc = torch.clamp(k, 1, length - 2)
    ym1 = safe.take1_last(m, kc - 1)
    y0 = safe.take1_last(m, kc)
    yp1 = safe.take1_last(m, kc + 1)
    denom = ym1 - 2.0 * y0 + yp1
    flat = denom.abs() < 1e-12
    delta = 0.5 * (ym1 - yp1) / torch.where(flat, 1.0, denom)
    delta = torch.clamp(torch.where(flat, 0.0, delta), -0.999, 0.999)
    return torch.where((k >= 1) & (k <= length - 2), delta, 0.0)


def peak_to_sidelobe(m: torch.Tensor, k: torch.Tensor, *, exclude: int = 8) -> torch.Tensor:
    """Peak magnitude over the largest magnitude more than ``exclude`` lags away."""
    idx = torch.arange(m.shape[-1], device=m.device)
    dist = (idx - k.unsqueeze(-1)).abs()
    side_max = torch.where(dist > exclude, m, float("-inf")).amax(dim=-1)
    return safe.take1_last(m, k) / (torch.clamp(side_max, min=0.0) + 1e-12)


def peaks_from_lag_mags(
    m: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_lag: int,
    psr_exclude: int = 8,
) -> CorrelationPeak:
    """Peak pick from a ``[..., 2·max_lag+1]`` correlation-magnitude window."""
    k = safe.argmax_last(m)
    delta = parabolic_refine(m, k)
    lag = k.to(torch.float32) - float(max_lag) + delta
    return CorrelationPeak(
        lag_samples=lag,
        tau_s=lag / sample_rate_hz,
        peak_value=safe.take1_last(m, k),
        psr=peak_to_sidelobe(m, k, exclude=psr_exclude),
    )
