"""Wideband power survey scanner (rtl_power parity).

Port of ``radio_mapper_tpu/tools/power_scan.py``: plan a frequency range
into retune hops, integrate windowed power spectra per hop, and emit the
classic rtl_power CSV rows ``date, time, hz_low, hz_high, hz_step,
samples, dB, dB, ...``. Each hop's DSP is one batched windowed FFT and a
mean (or peak hold) over its integration frames, the port's
:func:`~radio_mapper_tpu_torch.ops.spectral.welch_psd_db` on the caller's
device (``device="cuda"`` by default): at 10 kHz bins nfft is 256 (the
matmul DFT), at 125 Hz bins 16384, where kernel K7 transforms the frames
on the card.

Edge cropping keeps only the flat center of each hop's passband (default
20%) and the DC bin is interpolated away from its neighbours, on the host
after the hop's one device-to-host copy, as the reference does.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
from typing import Iterable, List, Optional

import numpy as np
import torch

from radio_mapper_tpu_torch.ingest.sources import IQSource
from radio_mapper_tpu_torch.ops.spectral import welch_psd_db

MAX_HOPS = 3000  # rtl_power's hop limit
MAX_BINS = 1 << 21  # rtl_power's largest FFT


@dataclasses.dataclass(frozen=True)
class ScanHop:
    center_hz: float
    low_hz: float
    high_hz: float
    keep_bins: int  # bins retained after cropping
    first_kept_bin: int


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    hops: List[ScanHop]
    nfft: int
    bin_hz: float
    sample_rate_hz: float
    crop: float


@dataclasses.dataclass
class ScanResult:
    plan: ScanPlan
    power_db: List[np.ndarray]  # per hop, [keep_bins]
    samples_per_hop: int
    started: _dt.datetime
    finished: _dt.datetime

    def frequencies_hz(self) -> np.ndarray:
        out = []
        for hop, _ in zip(self.plan.hops, self.power_db):
            out.append(hop.low_hz + np.arange(hop.keep_bins) * self.plan.bin_hz)
        return np.concatenate(out)

    def flattened_db(self) -> np.ndarray:
        return np.concatenate(self.power_db)


def plan_scan(
    freq_lo_hz: float,
    freq_hi_hz: float,
    *,
    bin_hz: float = 10_000.0,
    sample_rate_hz: float = 2_048_000.0,
    crop: float = 0.2,
) -> ScanPlan:
    """Split [lo, hi] into hops of usable (cropped) bandwidth.

    Mirrors rtl_power's ``frequency_range``: power-of-two FFT size
    from the requested bin width, hop step = usable bandwidth after crop.
    """
    if freq_hi_hz <= freq_lo_hz:
        raise ValueError("freq_hi must be > freq_lo")
    nfft = 1
    while sample_rate_hz / nfft > bin_hz and nfft < MAX_BINS:
        nfft <<= 1
    actual_bin = sample_rate_hz / nfft
    usable = sample_rate_hz * (1.0 - crop)
    keep_bins = int(round(usable / actual_bin))
    keep_bins = min(keep_bins, nfft)
    first_kept = (nfft - keep_bins) // 2

    hops: List[ScanHop] = []
    low = freq_lo_hz
    while low < freq_hi_hz and len(hops) < MAX_HOPS:
        center = low + usable / 2.0
        hops.append(
            ScanHop(
                center_hz=center,
                low_hz=low,
                high_hz=min(low + usable, freq_hi_hz),
                keep_bins=keep_bins,
                first_kept_bin=first_kept,
            )
        )
        low += usable
    if len(hops) >= MAX_HOPS:
        raise ValueError(f"scan needs more than {MAX_HOPS} hops; increase bin size")
    return ScanPlan(hops=hops, nfft=nfft, bin_hz=actual_bin, sample_rate_hz=sample_rate_hz, crop=crop)


def _hop_psd(
    iq: np.ndarray, plan: ScanPlan, window: str, reduce: str = "mean",
    device: torch.device | str = "cuda",
) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(iq, dtype=np.complex64)).to(device)
    psd = welch_psd_db(x, nfft=plan.nfft, window=window, shift=True, reduce=reduce).cpu().numpy()
    # DC nuke: replace the center bin with its neighbors' mean.
    c = plan.nfft // 2
    psd[c] = 0.5 * (psd[c - 1] + psd[c + 1])
    return psd


def run_scan(
    source: IQSource,
    plan: ScanPlan,
    *,
    integration_s: float = 1.0,
    window: str = "hamming",
    settle_reads: int = 1,
    peak_hold: bool = False,
    device: torch.device | str = "cuda",
) -> ScanResult:
    """Sweep all hops once. Per hop: retune, flush, integrate (on
    ``device``), crop.

    ``peak_hold=True`` keeps the per-bin maximum over the integration
    interval instead of the mean (rtl_power ``-P``) — useful for catching
    intermittent bursts in a survey.
    """
    started = _dt.datetime.now(_dt.timezone.utc)
    samples_per_hop = max(plan.nfft, int(integration_s * plan.sample_rate_hz))
    # Round to a whole number of FFT frames.
    samples_per_hop -= samples_per_hop % plan.nfft
    rows: List[np.ndarray] = []
    for hop in plan.hops:
        source.tune(hop.center_hz)
        for _ in range(settle_reads):  # retune settle + flush
            source.read(plan.nfft)
        iq = source.read(samples_per_hop)
        psd = _hop_psd(iq, plan, window, reduce="peak" if peak_hold else "mean", device=device)
        rows.append(psd[hop.first_kept_bin : hop.first_kept_bin + hop.keep_bins].copy())
    return ScanResult(
        plan=plan,
        power_db=rows,
        samples_per_hop=samples_per_hop,
        started=started,
        finished=_dt.datetime.now(_dt.timezone.utc),
    )


def csv_rows(result: ScanResult) -> Iterable[str]:
    """rtl_power CSV: date, time, hz_low, hz_high, hz_step, samples, dB…"""
    date = result.finished.strftime("%Y-%m-%d")
    tm = result.finished.strftime("%H:%M:%S")
    for hop, dbs in zip(result.plan.hops, result.power_db):
        values = ", ".join(f"{v:.2f}" for v in dbs)
        yield (
            f"{date}, {tm}, {hop.low_hz:.0f}, {hop.high_hz:.0f}, "
            f"{result.plan.bin_hz:.2f}, {result.samples_per_hop}, {values}"
        )


def scan_to_csv(
    source: IQSource,
    freq_lo_hz: float,
    freq_hi_hz: float,
    *,
    out_path: Optional[str] = None,
    passes: int = 1,
    **kwargs,
) -> List[str]:
    """Convenience wrapper: plan + run + format (optionally append to
    file); ``kwargs`` go to :func:`run_scan` (``device`` among them)."""
    plan = plan_scan(
        freq_lo_hz,
        freq_hi_hz,
        bin_hz=kwargs.pop("bin_hz", 10_000.0),
        sample_rate_hz=getattr(source, "sample_rate_hz", 2_048_000.0),
        crop=kwargs.pop("crop", 0.2),
    )
    lines: List[str] = []
    for _ in range(passes):
        result = run_scan(source, plan, **kwargs)
        lines.extend(csv_rows(result))
    if out_path:
        with open(out_path, "a") as f:
            for line in lines:
                f.write(line + "\n")
    return lines
