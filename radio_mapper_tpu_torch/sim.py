"""Synthetic scenario generator: emitter at a known position → per-buoy IQ.

A numpy port of ``radio_mapper_tpu/sim.py`` (scenario classes,
``default_scenario`` and ``synthesize``): the same float64 arithmetic on
the same ``default_rng(seed)`` stream, so a seed gives the same capture
bit for bit in both packages. Delays are applied as frequency-domain
phase ramps, exact for the periodic block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from radio_mapper_tpu_torch import geo
from radio_mapper_tpu_torch.constants import SPEED_OF_LIGHT_M_S

# The reference's simulated 4-buoy Oklahoma City square.
OKC_BUOYS = (
    ("buoy-okc-north", 35.5513, -97.5322, 365.8),
    ("buoy-okc-east", 35.4676, -97.4085, 365.8),
    ("buoy-okc-south", 35.3842, -97.5322, 365.8),
    ("buoy-okc-west", 35.4676, -97.6559, 365.8),
)


@dataclasses.dataclass(frozen=True)
class Buoy:
    buoy_id: str
    lat: float
    lng: float
    alt_m: float = 0.0
    clock_error_s: float = 0.0  # fixed clock offset of this receiver
    snr_db: Optional[float] = None  # overrides scenario SNR if set


@dataclasses.dataclass(frozen=True)
class Emitter:
    lat: float
    lng: float
    alt_m: float = 0.0
    freq_offset_hz: float = 0.0  # offset from channel center
    bandwidth_hz: float = 12_500.0
    signal: str = "noise"  # noise | tone | bpsk | chirp | fm
    power_db: float = 0.0  # relative transmit power


@dataclasses.dataclass(frozen=True)
class Scenario:
    buoys: Tuple[Buoy, ...]
    emitters: Tuple[Emitter, ...]
    sample_rate_hz: float = 2_048_000.0
    center_frequency_mhz: float = 121.5
    block_len: int = 16_384
    snr_db: float = 20.0
    timing_jitter_s: float = 0.0  # std of random per-buoy clock error
    seed: int = 0

    @property
    def ref_origin(self) -> Tuple[float, float, float]:
        lat = float(np.mean([b.lat for b in self.buoys]))
        lng = float(np.mean([b.lng for b in self.buoys]))
        return lat, lng, 0.0

    def buoy_enu(self) -> np.ndarray:
        """[B, 3] float64 buoy positions in the scenario ENU frame."""
        lat0, lng0, alt0 = self.ref_origin
        return np.stack(
            [geo.lat_lng_to_enu_np(b.lat, b.lng, b.alt_m, lat0, lng0, alt0) for b in self.buoys]
        )

    def emitter_enu(self, e: Emitter) -> np.ndarray:
        lat0, lng0, alt0 = self.ref_origin
        return geo.lat_lng_to_enu_np(e.lat, e.lng, e.alt_m, lat0, lng0, alt0)


@dataclasses.dataclass
class Capture:
    """Synthesized per-buoy IQ and its ground truth."""

    iq: np.ndarray  # [B, N] complex128
    delays_s: np.ndarray  # [B, E] true propagation delay incl. clock error
    geometric_delays_s: np.ndarray  # [B, E] pure propagation delay
    amplitudes: np.ndarray  # [B, E] received amplitude
    buoy_enu: np.ndarray  # [B, 3]
    emitter_enu: np.ndarray  # [E, 3]
    scenario: Scenario


def _baseband_source(e: Emitter, n: int, fs: float, rng: np.random.Generator) -> np.ndarray:
    """Unit-power complex baseband source waveform of length n (float64)."""
    t = np.arange(n) / fs
    if e.signal == "tone":
        s = np.exp(2j * np.pi * e.freq_offset_hz * t)
    elif e.signal == "chirp":
        f0 = e.freq_offset_hz - e.bandwidth_hz / 2
        rate = e.bandwidth_hz / (n / fs)
        s = np.exp(2j * np.pi * (f0 * t + 0.5 * rate * t * t))
    elif e.signal == "bpsk":
        sym_rate = max(e.bandwidth_hz, fs / n)
        samples_per_sym = max(1, int(round(fs / sym_rate)))
        num_sym = n // samples_per_sym + 1
        bits = rng.integers(0, 2, num_sym) * 2.0 - 1.0
        s = np.repeat(bits, samples_per_sym)[:n].astype(np.complex128)
        s *= np.exp(2j * np.pi * e.freq_offset_hz * t)
    elif e.signal == "fm":
        msg = 0.6 * np.sin(2 * np.pi * 1100.0 * t) + 0.4 * np.sin(2 * np.pi * 2700.0 * t)
        dev = e.bandwidth_hz / 2.0
        phase = 2 * np.pi * np.cumsum(msg) * dev / fs
        s = np.exp(1j * (2 * np.pi * e.freq_offset_hz * t + phase))
    elif e.signal == "noise":
        spec = rng.normal(size=n) + 1j * rng.normal(size=n)
        f = np.fft.fftfreq(n, 1.0 / fs)
        mask = np.abs(f - e.freq_offset_hz) <= e.bandwidth_hz / 2.0
        if not mask.any():
            mask[np.argmin(np.abs(f - e.freq_offset_hz))] = True
        s = np.fft.ifft(spec * mask)
    else:
        raise ValueError(f"unknown signal model {e.signal!r}")
    p = np.mean(np.abs(s) ** 2)
    return s / np.sqrt(p + 1e-300)


def _apply_delay(s: np.ndarray, delay_s: float, fs: float) -> np.ndarray:
    """Exact (circular) fractional delay via frequency-domain phase ramp."""
    n = s.shape[-1]
    f = np.fft.fftfreq(n, 1.0 / fs)
    return np.fft.ifft(np.fft.fft(s) * np.exp(-2j * np.pi * f * delay_s))


def synthesize(scenario: Scenario) -> Capture:
    """Generate one aligned block of per-buoy IQ for the scenario."""
    rng = np.random.default_rng(scenario.seed)
    fs = scenario.sample_rate_hz
    n = scenario.block_len
    num_b = len(scenario.buoys)
    num_e = len(scenario.emitters)
    fc_hz = scenario.center_frequency_mhz * 1e6

    buoy_enu = scenario.buoy_enu()
    emitter_enu = np.stack([scenario.emitter_enu(e) for e in scenario.emitters])

    # Per-buoy clock error: fixed offset + random jitter.
    clock = np.array(
        [
            b.clock_error_s + (rng.normal() * scenario.timing_jitter_s)
            for b in scenario.buoys
        ]
    )

    geo_delays = np.zeros((num_b, num_e))
    delays = np.zeros((num_b, num_e))
    amps = np.zeros((num_b, num_e))
    iq = np.zeros((num_b, n), dtype=np.complex128)

    for ei, emitter in enumerate(scenario.emitters):
        src = _baseband_source(emitter, n, fs, rng)
        dists = np.linalg.norm(buoy_enu - emitter_enu[ei], axis=1)
        d_ref = float(np.min(dists))
        for bi in range(num_b):
            tau_geo = dists[bi] / SPEED_OF_LIGHT_M_S
            tau = tau_geo + clock[bi]
            geo_delays[bi, ei] = tau_geo
            delays[bi, ei] = tau
            # Free-space 1/d amplitude, normalized to the closest buoy,
            # scaled by transmit power.
            amp = (d_ref / max(dists[bi], 1.0)) * 10.0 ** (emitter.power_db / 20.0)
            amps[bi, ei] = amp
            # Carrier phase rotation from the true RF delay.
            carrier = np.exp(-2j * np.pi * fc_hz * tau_geo)
            iq[bi] += amp * carrier * _apply_delay(src, tau, fs)

    # AWGN at the requested per-buoy SNR (relative to that buoy's signal).
    for bi, b in enumerate(scenario.buoys):
        snr = b.snr_db if b.snr_db is not None else scenario.snr_db
        sig_p = np.mean(np.abs(iq[bi]) ** 2)
        noise_p = sig_p / (10.0 ** (snr / 10.0)) if sig_p > 0 else 1.0
        noise = (rng.normal(size=n) + 1j * rng.normal(size=n)) * np.sqrt(noise_p / 2.0)
        iq[bi] += noise

    return Capture(
        iq=iq,
        delays_s=delays,
        geometric_delays_s=geo_delays,
        amplitudes=amps,
        buoy_enu=buoy_enu,
        emitter_enu=emitter_enu,
        scenario=scenario,
    )


def default_scenario(
    *,
    emitter_lat: float = 35.47,
    emitter_lng: float = -97.51,
    signal: str = "noise",
    bandwidth_hz: float = 25_000.0,
    freq_offset_hz: float = 0.0,
    snr_db: float = 20.0,
    block_len: int = 16_384,
    sample_rate_hz: float = 2_048_000.0,
    timing_jitter_s: float = 0.0,
    seed: int = 0,
    buoys: Optional[Sequence[Tuple[str, float, float, float]]] = None,
) -> Scenario:
    """The reference's OKC test network with one emitter.

    The detector notches ±10 kHz around the tuned center, so a narrowband
    emitter meant to be *detected* needs ``freq_offset_hz`` outside it.
    """
    buoys = buoys if buoys is not None else OKC_BUOYS
    return Scenario(
        buoys=tuple(Buoy(bid, lat, lng, alt) for bid, lat, lng, alt in buoys),
        emitters=(
            Emitter(
                lat=emitter_lat,
                lng=emitter_lng,
                signal=signal,
                bandwidth_hz=bandwidth_hz,
                freq_offset_hz=freq_offset_hz,
            ),
        ),
        sample_rate_hz=sample_rate_hz,
        block_len=block_len,
        snr_db=snr_db,
        timing_jitter_s=timing_jitter_s,
        seed=seed,
    )
