"""The buoy's live detection dwell.

Port of the body of ``radio_mapper_tpu/runtime/buoy.py``
``BuoyNode._detector.fn``: the split-complex power spectrum of one dwell
(kernel K7 at 16384, 32768 and 65536 samples on the card), the
natural-order top-K detector with its default stride-1 noise floor, and
the −3 dB bandwidth of every peak over a 9-bin boxcar. The service
around it is :mod:`radio_mapper_tpu_torch.runtime.buoy`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from radio_mapper_tpu_torch.ops import detect as detect_ops
from radio_mapper_tpu_torch.ops import spectral
from radio_mapper_tpu_torch.ops import split_complex as sc_ops

BANDWIDTH_SMOOTH_BINS = 9  # the buoy's boxcar for the bandwidth walk


def detect_dwell(
    re: torch.Tensor,
    im: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_peaks: int,
    threshold_db: float,
    power_offset_db: float,
) -> Tuple[detect_ops.PeakSet, torch.Tensor]:
    """Peaks of one float32 dwell ``re/im [..., N]`` and the bandwidth of
    each, ``[..., max_peaks]`` Hz. ``bin_index`` is on the N-point grid."""
    power_db = sc_ops.power_spectrum_db_split(re, im) + power_offset_db
    peaks = detect_ops.detect_peaks(
        power_db,
        sample_rate_hz=sample_rate_hz,
        max_peaks=max_peaks,
        threshold_db=threshold_db,
    )
    bw = spectral.estimate_bandwidth_hz(
        power_db.unsqueeze(-2),  # broadcasts against the K peaks
        peaks.bin_index,
        sample_rate_hz,
        smooth_bins=BANDWIDTH_SMOOTH_BINS,
    )
    return peaks, bw
