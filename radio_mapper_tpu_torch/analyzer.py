"""Offline IQ capture analyzer.

Parity with the reference's `signal_analyzer.py`: load raw uint8 I/Q
``.bin`` captures, compute an fftshifted power spectrum, find peaks above
mean+10 dB, report power/peak/RMS statistics, optionally render a PNG —
plus batch mode over ``iq_capture_*.bin`` files
(`signal_analyzer.py:14-213`).

Port of ``radio_mapper_tpu/analyzer.py``. The spectrum is
``torch.fft.fft`` in complex128 on ``device`` (the card unless the caller
asks for the CPU); complex128 keeps the peak list equal to the JAX
package's numpy spectrum. The peak walk runs on the host.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional

import numpy as np
import torch

from radio_mapper_tpu_torch.ops import iq as iq_ops


@dataclasses.dataclass
class CaptureAnalysis:
    path: str
    num_samples: int
    sample_rate_hz: float
    center_frequency_hz: float
    mean_power_db: float
    max_power_db: float
    rms: float
    dc_offset: complex
    peak_frequencies_hz: List[float]
    peak_powers_db: List[float]

    def summary(self) -> str:
        lines = [
            f"file: {self.path}",
            f"samples: {self.num_samples} @ {self.sample_rate_hz/1e6:.3f} MS/s",
            f"mean power: {self.mean_power_db:.1f} dB   max: {self.max_power_db:.1f} dB",
            f"rms: {self.rms:.2f}   dc offset: {self.dc_offset.real:.2f}{self.dc_offset.imag:+.2f}j",
            f"peaks: {len(self.peak_frequencies_hz)}",
        ]
        for f, p in zip(self.peak_frequencies_hz, self.peak_powers_db):
            lines.append(f"  {(self.center_frequency_hz + f)/1e6:12.4f} MHz  {p:7.1f} dB")
        return "\n".join(lines)


def analyze_iq_file(
    path: str,
    *,
    sample_rate_hz: float = 2_048_000.0,
    center_frequency_hz: float = 0.0,
    peak_above_mean_db: float = 10.0,
    max_peaks: int = 16,
    plot_path: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> CaptureAnalysis:
    """Analyze one capture (`signal_analyzer.py:47-176` semantics)."""
    data = iq_ops.load_iq_bin(path)
    n = data.size
    if n == 0:
        raise ValueError(f"empty capture: {path}")

    x = torch.from_numpy(data).to(device)
    spec = torch.fft.fftshift(torch.fft.fft(x))
    power_db = (20.0 * torch.log10(spec.abs() + 1e-12)).cpu().numpy()
    freqs = np.fft.fftshift(np.fft.fftfreq(n, 1.0 / sample_rate_hz))

    mean_db = float(np.mean(power_db))
    threshold = mean_db + peak_above_mean_db
    # Local maxima above mean+10 dB, min spacing ~n/1000 bins.
    spacing = max(1, n // 1000)
    candidates = np.flatnonzero(
        (power_db > threshold)
        & (power_db >= np.roll(power_db, 1))
        & (power_db >= np.roll(power_db, -1))
    )
    order = candidates[np.argsort(power_db[candidates])[::-1]]
    kept: List[int] = []
    for k in order:
        if all(abs(k - j) >= spacing for j in kept):
            kept.append(int(k))
        if len(kept) >= max_peaks:
            break
    kept.sort()

    analysis = CaptureAnalysis(
        path=path,
        num_samples=n,
        sample_rate_hz=sample_rate_hz,
        center_frequency_hz=center_frequency_hz,
        mean_power_db=mean_db,
        max_power_db=float(power_db.max()),
        rms=float(np.sqrt(np.mean(np.abs(data) ** 2))),
        dc_offset=complex(np.mean(data)),
        peak_frequencies_hz=[float(freqs[k]) for k in kept],
        peak_powers_db=[float(power_db[k]) for k in kept],
    )

    if plot_path:
        _render_spectrum_png(freqs, power_db, center_frequency_hz, analysis, plot_path)
    return analysis


def _render_spectrum_png(freqs, power_db, fc, analysis, plot_path):
    """Spectrum plot (`signal_analyzer.py:114-134`); decimated for speed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    step = max(1, len(freqs) // 8192)
    fig, ax = plt.subplots(figsize=(11, 5))
    ax.plot((freqs[::step] + fc) / 1e6, power_db[::step], lw=0.6)
    for f, p in zip(analysis.peak_frequencies_hz, analysis.peak_powers_db):
        ax.plot((f + fc) / 1e6, p, "rv", ms=6)
    ax.set_xlabel("Frequency (MHz)")
    ax.set_ylabel("Power (dB)")
    ax.set_title(os.path.basename(analysis.path))
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(plot_path, dpi=110)
    plt.close(fig)


def analyze_directory(
    directory: str = ".", pattern: str = "iq_capture_*.bin", **kwargs
) -> List[CaptureAnalysis]:
    """Batch mode (`signal_analyzer.py:178-213`)."""
    return [
        analyze_iq_file(p, **kwargs)
        for p in sorted(glob.glob(os.path.join(directory, pattern)))
    ]
