"""Spectral peak detection: the fused detector's top-K tail and the
natural-order detector.

Port of ``radio_mapper_tpu/ops/detect.py``:

- ``peaks_from_ct_partials`` (single-dwell route): kernel K1
  (:mod:`.cuda.fft_detect`), K4 (:mod:`.cuda.detect_ct`) or K8
  (:mod:`.cuda.channel_step`) already applied every gate and reduced each
  8-bin segment to (max, argmax); this tail picks the K strongest
  segments and converts only those to dB / frequency / confidence;
- ``detect_peaks_ct``: K4 on CT-order spectra (or given partials), then
  that tail; and the routing knobs of the fused detect
  (``set_fused_detect``, ``set_fused_fft_detect``, and
  ``set_combined_topk``, which finishes the selection inside K1:
  ``kernel_topk``);
- ``detect_peaks`` and ``sliding_local_max`` (multi-dwell route and the
  buoy dwell) on a natural-order dB spectrum, with the reference's
  safe-mode semantics — the ones the TPU runs: circular sliding max,
  bisected median floor, segmented top-K with the lowest-index
  tie-break; and ``detect_signals``, the complex power spectrum then
  ``detect_peaks`` (the complex step's detector).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from radio_mapper_tpu_torch import constants
from radio_mapper_tpu_torch.ops import ct_plan, safe, spectral
from radio_mapper_tpu_torch.ops.cuda import detect_ct, fft_detect


class PeakSet(NamedTuple):
    """Fixed-size set of detected peaks; all tensors are ``[..., K]``.

    ``bin_index`` is relative to the spectrum that was detected on, which
    depends on the route: the single-dwell route detects on the
    nfft-point grid of the padded CT spectrum, the multi-dwell route and
    the buoy dwell on the block_len grid. ``freq_offset_hz`` is computed
    with the matching bin spacing and compares across routes.
    """

    bin_index: torch.Tensor  # int32 FFT bin (un-shifted order, DC at 0; grid depends on the route)
    freq_offset_hz: torch.Tensor  # float32 offset from tuned center
    power_db: torch.Tensor  # float32 peak power
    snr_db: torch.Tensor  # float32 power above median noise floor
    confidence: torch.Tensor  # float32 in [0, 1]
    valid: torch.Tensor  # bool — False entries are padding
    noise_floor_db: torch.Tensor  # float32, [...] (no K axis)


# Routing of the single-dwell detect stage (the reference's trace-time
# knobs). "auto" means what it means on the TPU, where the reference runs
# in safe mode as the port always does: the fused detect whenever
# detect_ct.supported says it covers the configuration; "on" is the same;
# "off" sends the stage to ct_power_db + the natural-order detect_peaks.
_FUSED_DETECT = "auto"
# "auto"/"on": the forward transform and the detect run as one kernel
# (K1) whenever the fused detect runs; "off": two kernels, K3 then K4.
_FUSED_FFT_DETECT = "auto"


def set_fused_detect(mode: str) -> None:
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused-detect mode {mode!r}")
    global _FUSED_DETECT
    _FUSED_DETECT = mode


def set_fused_fft_detect(mode: str) -> None:
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused-fft-detect mode {mode!r}")
    global _FUSED_FFT_DETECT
    _FUSED_FFT_DETECT = mode


# Finish the peak selection inside K1 (its ``emit_topk``) on the combined
# route: the F/8 partials are never written and the tail only unpacks.
# Off by default, as in the reference.
_COMBINED_TOPK = False


def set_combined_topk(on: bool) -> None:
    global _COMBINED_TOPK
    _COMBINED_TOPK = bool(on)


def combined_topk_enabled() -> bool:
    return _COMBINED_TOPK


def fused_detect_enabled(nfft: int, *, min_distance_bins: int, noise_floor_stride: int) -> bool:
    """Route the detect stage to the fused CT-order detect (K1 or K4)?"""
    if _FUSED_DETECT == "off":
        return False
    return detect_ct.supported(
        nfft, min_distance_bins=min_distance_bins, noise_floor_stride=noise_floor_stride
    )


def fused_fft_detect_enabled(nfft: int, *, min_distance_bins: int, noise_floor_stride: int) -> bool:
    """Route the forward FFT and the detect to the one kernel K1?"""
    if _FUSED_FFT_DETECT == "off":
        return False
    return fused_detect_enabled(
        nfft, min_distance_bins=min_distance_bins, noise_floor_stride=noise_floor_stride
    )


def detect_peaks_ct(
    spec_re: torch.Tensor,
    spec_im: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_peaks: int = 8,
    threshold_db: float = constants.DEFAULT_DETECTION_THRESHOLD_DBM,
    min_distance_bins: int = constants.DEFAULT_PEAK_MIN_DISTANCE_BINS,
    dc_notch_hz: Optional[float] = constants.DEFAULT_DC_NOTCH_HZ,
    confidence_floor: float = constants.DEFAULT_CONFIDENCE_FLOOR,
    snr_fullscale_db: float = constants.DEFAULT_SNR_FULLSCALE_DB,
    power_offset_db: float = 0.0,
    kernel_topk: bool = False,
    partials=None,
) -> PeakSet:
    """Top-K peaks of CT-order spectra ``[..., nfft]``.

    Kernel K4 (:func:`.cuda.detect_ct.detect_ct_partials`) computes the
    segment partials, unless ``partials = (seg_score, seg_arg,
    noise_floor_db)`` come from K1 or K8 run with the same parameters;
    then :func:`peaks_from_ct_partials`. With ``kernel_topk`` the kernel
    (K4 here, or K1 for given partials) ran ``emit_topk = max_peaks`` and
    the partials are its packed top-K blocks. Equal to ``detect_peaks(
    ct_power_db(fr, fi) + power_offset_db, noise_floor_stride=8, ...)``
    up to the floor's last ulps, except that exactly-equal candidates in
    different segments tie-break by CT segment order.
    """
    nfft = spec_re.shape[-1]
    if partials is None:
        plan = ct_plan.detect_plan(
            nfft,
            sample_rate_hz=sample_rate_hz,
            threshold_db=threshold_db,
            min_distance_bins=min_distance_bins,
            dc_notch_hz=dc_notch_hz,
            confidence_floor=confidence_floor,
            snr_fullscale_db=snr_fullscale_db,
            power_offset_db=power_offset_db,
        )
        batch = spec_re.shape[:-1]
        rows = lambda a: a.reshape(-1, nfft).contiguous()
        score, arg, nf = detect_ct.detect_ct_partials(
            rows(spec_re), rows(spec_im), plan, emit_topk=max_peaks if kernel_topk else 0
        )
        cols = score.shape[-1]
        partials = (score.reshape(*batch, cols), arg.reshape(*batch, cols), nf.reshape(batch))
    return peaks_from_ct_partials(
        *partials,
        nfft=nfft,
        sample_rate_hz=sample_rate_hz,
        max_peaks=max_peaks,
        snr_fullscale_db=snr_fullscale_db,
        power_offset_db=power_offset_db,
        kernel_topk=kernel_topk,
    )


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
    kernel_topk: bool = False,
) -> PeakSet:
    """K winners from ``[..., nfft/8]`` partials (linear power, −inf where
    a segment holds no candidate; float in-segment offsets 0-7) and the
    ``[...]`` noise floor in dB. With ``kernel_topk`` the selection already
    ran in the kernel (``emit_topk = max_peaks``): ``score`` holds the K
    winners' values and ``seg_arg`` their packed ``8·f + off`` (exact in
    float32) in its first K lanes, which are only unpacked here."""
    n1, n2 = ct_plan.ct_split(nfft)
    if not kernel_topk:  # the selection the kernel's emit_topk runs
        score, seg_arg = fft_detect.topk_plain(score, seg_arg, max_peaks)
    top_vals = score[..., :max_peaks]
    packed = seg_arg[..., :max_peaks].to(torch.int64)
    top_f = packed // ct_plan.SEGMENT
    off = packed - top_f * ct_plan.SEGMENT
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


def sliding_local_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """True where ``x`` equals the max of its circular ±radius window
    (last axis)."""
    return x >= safe.sliding_max(x, radius)


def detect_peaks(
    power_db: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_peaks: int = 8,
    threshold_db: float = constants.DEFAULT_DETECTION_THRESHOLD_DBM,
    min_distance_bins: int = constants.DEFAULT_PEAK_MIN_DISTANCE_BINS,
    dc_notch_hz: Optional[float] = constants.DEFAULT_DC_NOTCH_HZ,
    confidence_floor: float = constants.DEFAULT_CONFIDENCE_FLOOR,
    snr_fullscale_db: float = constants.DEFAULT_SNR_FULLSCALE_DB,
    noise_floor_stride: int = 1,
) -> PeakSet:
    """Top-K spectral peaks of ``power_db [..., F]`` (dB, un-shifted bin
    order), sorted by power, invalid slots masked and zero-filled.

    The noise floor is the bisected median of every ``noise_floor_stride``-th
    bin; a candidate is a circular ±``min_distance_bins`` local max above
    ``threshold_db``, outside the static DC notch and at least
    ``confidence_floor · snr_fullscale_db`` above the floor (a floor above
    1 passes nothing, one at or below 0 disables the gate).
    """
    f = power_db.shape[-1]
    dev = power_db.device
    nf_src = power_db[..., ::noise_floor_stride] if noise_floor_stride > 1 else power_db
    noise_floor = safe.median_bisect(nf_src)

    candidate = sliding_local_max(power_db, min_distance_bins) & (power_db > threshold_db)
    if dc_notch_hz is not None:
        keep = np.abs(spectral.fft_frequencies_hz(f, sample_rate_hz)) >= dc_notch_hz
        candidate = candidate & torch.from_numpy(keep).to(dev)
    if confidence_floor > 1.0:
        candidate = torch.zeros_like(candidate)
    elif confidence_floor > 0.0:
        candidate = candidate & (
            power_db - noise_floor.unsqueeze(-1) >= confidence_floor * snr_fullscale_db
        )

    score = torch.where(candidate, power_db, float("-inf"))
    seg = ct_plan.SEGMENT
    if f % seg == 0 and min_distance_bins + 1 >= seg:
        top_vals, top_idx = safe.top_k_segmented(score, max_peaks, seg)
    else:
        top_vals, top_idx = safe.top_k(score, max_peaks)
    valid = torch.isfinite(top_vals)
    peak_snr = top_vals - noise_floor.unsqueeze(-1)
    peak_conf = torch.clamp(peak_snr / snr_fullscale_db, 0.0, 1.0)
    # fftfreq arithmetically: bins ≤ (F−1)//2 are positive, the rest wrap
    kf = top_idx.to(torch.float32)
    peak_freq = torch.where(top_idx <= (f - 1) // 2, kf, kf - f) * (sample_rate_hz / f)
    zero = torch.zeros_like(peak_snr)
    return PeakSet(
        bin_index=torch.where(valid, top_idx, 0).to(torch.int32),
        freq_offset_hz=torch.where(valid, peak_freq, zero),
        power_db=torch.where(valid, top_vals, zero),
        snr_db=torch.where(valid, peak_snr, zero),
        confidence=torch.where(valid, peak_conf, zero),
        valid=valid,
        noise_floor_db=noise_floor,
    )


def detect_signals(
    iq: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_peaks: int = 8,
    power_offset_db: float = 0.0,
    **peak_kwargs,
) -> PeakSet:
    """Top-K peaks of complex ``iq [..., N]``: :func:`.spectral.power_spectrum_db`
    plus ``power_offset_db`` (the calibration to the reference's raw-count
    "dBm" scale), then :func:`detect_peaks` with ``peak_kwargs``."""
    p = spectral.power_spectrum_db(iq) + power_offset_db
    return detect_peaks(p, sample_rate_hz=sample_rate_hz, max_peaks=max_peaks, **peak_kwargs)
