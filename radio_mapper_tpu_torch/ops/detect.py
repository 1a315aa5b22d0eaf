"""Top-K peak selection over the fused detector's segment partials.

Port of ``radio_mapper_tpu/ops/detect.py`` (``PeakSet``,
``peaks_from_ct_partials``). Kernel K1 (:mod:`.cuda.fft_detect`) already
applied every gate and reduced each 8-bin segment to (max, argmax); this
tail picks the K strongest segments and converts only those to
dB / frequency / confidence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radio_mapper_tpu_torch import constants
from radio_mapper_tpu_torch.ops import ct_plan, safe


class PeakSet(NamedTuple):
    """Fixed-size set of detected peaks; all tensors are ``[..., K]``.

    ``bin_index`` is on the nfft-point grid of the padded CT spectrum;
    ``freq_offset_hz`` is computed with that grid's bin spacing.
    """

    bin_index: torch.Tensor  # int32 FFT bin (un-shifted order, DC at 0)
    freq_offset_hz: torch.Tensor  # float32 offset from tuned center
    power_db: torch.Tensor  # float32 peak power
    snr_db: torch.Tensor  # float32 power above median noise floor
    confidence: torch.Tensor  # float32 in [0, 1]
    valid: torch.Tensor  # bool — False entries are padding
    noise_floor_db: torch.Tensor  # float32, [...] (no K axis)


def peaks_from_ct_partials(
    score: torch.Tensor,
    seg_arg: torch.Tensor,
    noise_floor: torch.Tensor,
    *,
    nfft: int,
    sample_rate_hz: float,
    max_peaks: int = 8,
    snr_fullscale_db: float = constants.DEFAULT_SNR_FULLSCALE_DB,
    power_offset_db: float = 0.0,
) -> PeakSet:
    """K winners from ``[..., nfft/8]`` partials (linear power, −inf where
    a segment holds no candidate; float in-segment offsets 0-7) and the
    ``[...]`` noise floor in dB."""
    n1, n2 = ct_plan.ct_split(nfft)
    top_vals, top_f = safe.top_k(score, max_peaks)
    off = torch.gather(seg_arg, -1, top_f).to(torch.int64)
    # segment f = b2·n1 + k1 covers natural bins (8·b2 + off) + n2·k1
    b2 = top_f // n1
    k1 = top_f - b2 * n1
    top_idx = ct_plan.SEGMENT * b2 + off + n2 * k1
    valid = torch.isfinite(top_vals)
    vals_safe = torch.where(valid, top_vals, 1.0)
    top_db = 10.0 * torch.log10(vals_safe + 1e-24) + power_offset_db
    peak_snr = top_db - noise_floor.unsqueeze(-1)
    peak_conf = torch.clamp(peak_snr / snr_fullscale_db, 0.0, 1.0)
    kf = top_idx.to(torch.float32)
    peak_freq = torch.where(top_idx <= (nfft - 1) // 2, kf, kf - nfft) * (sample_rate_hz / nfft)
    zero = torch.zeros_like(peak_snr)
    return PeakSet(
        bin_index=torch.where(valid, top_idx, 0).to(torch.int32),
        freq_offset_hz=torch.where(valid, peak_freq, zero),
        power_db=torch.where(valid, top_db, zero),
        snr_db=torch.where(valid, peak_snr, zero),
        confidence=torch.where(valid, peak_conf, zero),
        valid=valid,
        noise_floor_db=noise_floor,
    )
