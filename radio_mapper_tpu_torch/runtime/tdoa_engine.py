"""The central node's TDOA engine: detections → measurements → position fixes.

Port of ``radio_mapper_tpu/runtime/tdoa_engine.py``: frequency grouping
within ±0.01 MHz, the 10 s correlation window, the 3-buoy gate,
all-pairs measurements and the LM solve in a local ENU frame. Two
measurement modes:

- timestamp mode: Δt from the detections' ``gps_timestamp_ns``;
- waveform mode (:meth:`TDoAEngine.measurements_from_waveforms`): when
  the detections carry IQ snippets of one GPS-PPS-aligned dwell, Δt comes
  from the all-pairs GCC-PHAT of the snippets
  (:func:`..ops.gcc_phat.gcc_phat_all_pairs`), to a fraction of a sample
  whatever the buoys' clock-reading error; such fixes carry
  ``method="gcc-phat+lm"``. Timestamps remain the fallback when fewer
  than ``min_buoys`` snippets qualify.

The snippet GCC and the multi-start LM solve run on the engine's
``device`` (the card by default). The reference pins its GCC to the CPU;
a caller who wants that passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch import geo, solver
from radio_mapper_tpu_torch.constants import (
    DEFAULT_CORRELATION_WINDOW_S,
    DEFAULT_FREQ_TOLERANCE_MHZ,
    DEFAULT_MIN_BUOYS,
    SPEED_OF_LIGHT_M_S,
)
from radio_mapper_tpu_torch.ops import gcc_phat as gcc_ops
from radio_mapper_tpu_torch.runtime.datamodel import (
    BuoyPosition,
    SignalDetection,
    TDoAMeasurement,
    TriangulationResult,
    utc_now_iso,
)

logger = logging.getLogger(__name__)


def group_by_frequency(
    detections: Sequence[SignalDetection],
    tolerance_mhz: float = DEFAULT_FREQ_TOLERANCE_MHZ,
) -> Dict[float, List[SignalDetection]]:
    """Group detections whose frequencies lie within ±tolerance of a
    group's first frequency (in arrival order)."""
    groups: Dict[float, List[SignalDetection]] = {}
    for det in detections:
        for f in groups:
            if abs(det.frequency_mhz - f) <= tolerance_mhz:
                groups[f].append(det)
                break
        else:
            groups[det.frequency_mhz] = [det]
    return groups


def filter_time_window(
    detections: Sequence[SignalDetection], window_s: float
) -> List[SignalDetection]:
    """The detections within ``window_s`` of the newest, oldest first."""
    if not detections:
        return []
    ordered = sorted(detections, key=lambda d: d.gps_timestamp_ns)
    earliest = ordered[-1].gps_timestamp_ns - int(window_s * 1e9)
    return [d for d in ordered if d.gps_timestamp_ns >= earliest]


def timing_confidence(b1: BuoyPosition, b2: BuoyPosition) -> float:
    """exp(−σ_combined / 100 µs), σ_combined the two clocks' 1σ in quadrature."""
    combined = float(np.hypot(b1.timing_accuracy_ns, b2.timing_accuracy_ns))
    return min(float(np.exp(-combined / 100_000.0)), 1.0)


class TDoAEngine:
    def __init__(
        self,
        *,
        min_buoys: int = DEFAULT_MIN_BUOYS,
        correlation_window_s: float = DEFAULT_CORRELATION_WINDOW_S,
        frequency_tolerance_mhz: float = DEFAULT_FREQ_TOLERANCE_MHZ,
        solver_iterations: int = 40,
        solver_starts: int = 4,
        waveform_mode: str = "auto",  # auto | always | never
        waveform_max_lag: Optional[int] = None,
        # Same-dwell anchor clustering tolerance: absorbs the clock-reading
        # error (~100 µs class) while staying well below the dwell spacing.
        waveform_anchor_tolerance_s: float = 0.05,
        gcc_eps: float = 0.05,
        psr_floor: float = 1.2,
        psr_scale: float = 2.0,
        device: torch.device | str = "cuda",
    ):
        if waveform_mode not in ("auto", "always", "never"):
            raise ValueError(f"unknown waveform_mode {waveform_mode!r}")
        self.buoy_positions: Dict[str, BuoyPosition] = {}
        self.min_buoys = min_buoys
        self.correlation_window_s = correlation_window_s
        self.frequency_tolerance_mhz = frequency_tolerance_mhz
        self.solver_iterations = solver_iterations
        self.solver_starts = solver_starts
        self.waveform_mode = waveform_mode
        self.waveform_max_lag = waveform_max_lag
        self.waveform_anchor_tolerance_s = waveform_anchor_tolerance_s
        self.gcc_eps = gcc_eps
        self.psr_floor = psr_floor
        self.psr_scale = psr_scale
        self.device = torch.device(device)
        # the sample rate of the last waveform group, for the solve's σ floor
        self._last_waveform_fs = 0.0

    # -- registry ---------------------------------------------------------

    def register_buoy(self, pos: BuoyPosition) -> None:
        self.buoy_positions[pos.buoy_id] = pos
        logger.info("Registered buoy %s at (%.6f, %.6f)", pos.buoy_id, pos.lat, pos.lng)

    def get_network_status(self) -> Dict:
        return {
            "registered_buoys": len(self.buoy_positions),
            "buoy_list": [
                {
                    "buoy_id": p.buoy_id,
                    "lat": p.lat,
                    "lng": p.lng,
                    "timing_accuracy_ns": p.timing_accuracy_ns,
                }
                for p in self.buoy_positions.values()
            ],
            "min_buoys_required": self.min_buoys,
            "correlation_window_s": self.correlation_window_s,
            "triangulation_ready": len(self.buoy_positions) >= self.min_buoys,
        }

    # -- measurements -----------------------------------------------------

    def measurements_from_timestamps(
        self, detections: Sequence[SignalDetection]
    ) -> List[TDoAMeasurement]:
        """All-pairs Δt from the detections' timestamps."""
        out: List[TDoAMeasurement] = []
        for i in range(len(detections)):
            for j in range(i + 1, len(detections)):
                d1, d2 = detections[i], detections[j]
                if abs(d1.frequency_mhz - d2.frequency_mhz) > self.frequency_tolerance_mhz:
                    continue
                p1 = self.buoy_positions.get(d1.buoy_id)
                p2 = self.buoy_positions.get(d2.buoy_id)
                if p1 is None or p2 is None:
                    continue
                dt_ns = d2.gps_timestamp_ns - d1.gps_timestamp_ns
                out.append(
                    TDoAMeasurement(
                        buoy1_id=d1.buoy_id,
                        buoy2_id=d2.buoy_id,
                        time_difference_ns=dt_ns,
                        distance_difference_m=dt_ns / 1e9 * SPEED_OF_LIGHT_M_S,
                        confidence=min(d1.confidence, d2.confidence) * timing_confidence(p1, p2),
                        frequency_mhz=d1.frequency_mhz,
                    )
                )
        return out

    def _anchors_enu(self, buoy_ids: Sequence[str]) -> Tuple[np.ndarray, float, float]:
        """Float64 ENU positions of ``buoy_ids`` around their mean lat/lng,
        and that origin."""
        positions = [self.buoy_positions[b] for b in buoy_ids]
        lat0 = float(np.mean([p.lat for p in positions]))
        lng0 = float(np.mean([p.lng for p in positions]))
        enu = np.stack(
            [geo.lat_lng_to_enu_np(p.lat, p.lng, p.altitude, lat0, lng0, 0.0) for p in positions]
        )
        return enu, lat0, lng0

    def _waveform_max_lag(self, buoy_ids: Sequence[str], n: int, fs: float) -> int:
        """A lag window covering the largest baseline among ``buoy_ids``
        (+16 samples, rounded up to a multiple of 64), at most n − 1."""
        if self.waveform_max_lag is not None:
            return min(self.waveform_max_lag, n - 1)
        enu, _, _ = self._anchors_enu(buoy_ids)
        baseline = 0.0
        for i in range(len(enu)):
            for j in range(i + 1, len(enu)):
                baseline = max(baseline, float(np.linalg.norm(enu[i] - enu[j])))
        lag = int(np.ceil(baseline / SPEED_OF_LIGHT_M_S * fs)) + 16
        lag = ((lag + 63) // 64) * 64
        return max(64, min(lag, n - 1))

    def measurements_from_waveforms(
        self, detections: Sequence[SignalDetection]
    ) -> List[TDoAMeasurement]:
        """All-pairs sub-sample Δt from the detections' IQ snippets.

        A detection qualifies with an ``iq_samples`` snippet, a registered
        buoy and the group's one common ``iq_sample_rate_hz``; snippets are
        clustered by ``iq_anchor_ns`` (within
        ``waveform_anchor_tolerance_s``), and the cluster covering the most
        buoys (the newest on a tie) is correlated, the most confident
        detection of each buoy, cut to the shortest snippet. Returns []
        when fewer than ``min_buoys`` qualify.
        """
        cands = [
            d
            for d in detections
            if d.iq_samples is not None and len(d.iq_samples) and d.buoy_id in self.buoy_positions
        ]
        if len({d.buoy_id for d in cands}) < self.min_buoys:
            return []
        rates = {round(float(d.iq_sample_rate_hz), 3) for d in cands}
        rates.discard(0.0)
        if len(rates) != 1:
            if len(rates) > 1:
                logger.warning("mixed snippet sample rates %s; waveform mode off", rates)
            return []
        fs = rates.pop()
        self._last_waveform_fs = fs

        tol_ns = self.waveform_anchor_tolerance_s * 1e9
        clusters: List[List[SignalDetection]] = []
        for d in sorted(cands, key=lambda d: d.iq_anchor_ns):
            if clusters and d.iq_anchor_ns - clusters[-1][0].iq_anchor_ns <= tol_ns:
                clusters[-1].append(d)
            else:
                clusters.append([d])
        cluster = max(clusters, key=lambda c: (len({d.buoy_id for d in c}), c[0].iq_anchor_ns))
        keep: Dict[str, SignalDetection] = {}
        for d in cluster:
            cur = keep.get(d.buoy_id)
            if cur is None or d.confidence > cur.confidence:
                keep[d.buoy_id] = d
        if len(keep) < self.min_buoys:
            return []

        buoy_ids = sorted(keep)
        n = min(len(keep[b].iq_samples) for b in buoy_ids)
        sig = np.stack([np.asarray(keep[b].iq_samples, np.complex64)[:n] for b in buoy_ids])
        max_lag = self._waveform_max_lag(buoy_ids, n, fs)
        # sample rate 1: the lags come back in samples, τ is formed here
        peaks = gcc_ops.gcc_phat_all_pairs(
            torch.from_numpy(sig).to(self.device), sample_rate_hz=1.0, max_lag=max_lag,
            weighting="phat", eps=self.gcc_eps,
        )
        lags = peaks.lag_samples.cpu().numpy().astype(np.float64)
        psr = peaks.psr.cpu().numpy().astype(np.float64)

        i_idx, j_idx = gcc_ops.pair_indices(len(buoy_ids))
        freq = float(np.median([keep[b].frequency_mhz for b in buoy_ids]))
        out: List[TDoAMeasurement] = []
        for p in range(len(i_idx)):
            bi, bj = buoy_ids[int(i_idx[p])], buoy_ids[int(j_idx[p])]
            tau_s = float(lags[p]) / fs  # lag > 0 ⇒ bi heard later
            quality = 0.1 + 0.9 * float(np.clip((psr[p] - self.psr_floor) / self.psr_scale, 0.0, 1.0))
            out.append(
                TDoAMeasurement(
                    buoy1_id=bj,
                    buoy2_id=bi,  # time_difference = t(buoy2) − t(buoy1) = τ
                    time_difference_ns=int(round(tau_s * 1e9)),
                    distance_difference_m=tau_s * SPEED_OF_LIGHT_M_S,
                    confidence=min(keep[bi].confidence, keep[bj].confidence) * quality,
                    frequency_mhz=freq,
                )
            )
        return out

    # -- solving ----------------------------------------------------------

    def _solve_group(
        self, measurements: List[TDoAMeasurement], sigma_floor_m: float = 0.0
    ) -> Optional[Tuple[float, float, float, float, float, Tuple[float, float, float]]]:
        """Multi-start LM solve of one measurement group in a local ENU
        frame, on the engine's device: ``(lat, lng, alt, accuracy_m,
        mean_confidence, (ellipse_major_m, ellipse_minor_m,
        ellipse_orientation_deg))``, or None."""
        buoy_ids = sorted({m.buoy1_id for m in measurements} | {m.buoy2_id for m in measurements})
        if len(buoy_ids) < self.min_buoys:
            return None
        index = {b: k for k, b in enumerate(buoy_ids)}
        enu, lat0, lng0 = self._anchors_enu(buoy_ids)
        # time_difference_ns = t(buoy2) − t(buoy1): receiver "i" = buoy2 heard
        # later, as the solver's dd = ‖x−p_i‖ − ‖x−p_j‖
        pair_i = [index[m.buoy2_id] for m in measurements]
        pair_j = [index[m.buoy1_id] for m in measurements]
        dd = np.array([m.distance_difference_m for m in measurements], np.float32)
        w = np.array([max(m.confidence, 0.0) for m in measurements], np.float32)
        if not np.any(w > 0):
            w = np.ones_like(w)
        on = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device=self.device)
        res = solver.solve_tdoa_multistart(
            on(enu.astype(np.float32), torch.float32),
            on(pair_i, torch.int64),
            on(pair_j, torch.int64),
            on(dd, torch.float32),
            on(w, torch.float32),
            num_starts=self.solver_starts,
            iterations=self.solver_iterations,
            sigma_floor_m=np.float32(sigma_floor_m),
        )
        pos = res.position_enu.cpu().numpy().astype(np.float64)
        if not np.all(np.isfinite(pos)):
            return None
        lat, lng, alt = geo.enu_to_lat_lng(pos, lat0, lng0, 0.0)
        mean_conf = float(np.mean([m.confidence for m in measurements]))
        ellipse = tuple(
            float(f.item()) for f in (res.ellipse_major_m, res.ellipse_minor_m, res.ellipse_orientation_deg)
        )
        return float(lat), float(lng), float(alt), float(res.residual_rms_m.item()), mean_conf, ellipse

    def process_signal_detections(
        self, detections: Sequence[SignalDetection]
    ) -> List[TriangulationResult]:
        """Group by frequency → time window → measure (waveforms, else
        timestamps) → solve, one :class:`TriangulationResult` a group."""
        results: List[TriangulationResult] = []
        if not detections:
            return results
        for freq, group in group_by_frequency(detections, self.frequency_tolerance_mhz).items():
            windowed = filter_time_window(group, self.correlation_window_s)
            if len({d.buoy_id for d in windowed}) < self.min_buoys:
                continue
            method = "hyperbolic-lm"
            measurements: List[TDoAMeasurement] = []
            if self.waveform_mode != "never":
                measurements = self.measurements_from_waveforms(windowed)
                if measurements:
                    method = "gcc-phat+lm"
            if not measurements and self.waveform_mode != "always":
                measurements = self.measurements_from_timestamps(windowed)
            if len(measurements) < 2:
                continue
            # The ellipse's σ floor: waveform τ is good to ~0.2 sample;
            # timestamps only to c·median(timing accuracy) of the buoys.
            floor = 0.0
            if method == "gcc-phat+lm" and self._last_waveform_fs:
                floor = 0.2 * SPEED_OF_LIGHT_M_S / self._last_waveform_fs
            elif method == "hyperbolic-lm":
                accs = [
                    self.buoy_positions[b].timing_accuracy_ns
                    for m in measurements
                    for b in (m.buoy1_id, m.buoy2_id)
                    if b in self.buoy_positions
                ]
                if accs:
                    floor = SPEED_OF_LIGHT_M_S * float(np.median(accs)) * 1e-9
            solved = self._solve_group(measurements, sigma_floor_m=floor)
            if solved is None:
                continue
            lat, lng, alt, accuracy, conf, ellipse = solved
            types = [d.signal_type for d in windowed]
            common_type = max(set(types), key=types.count)
            results.append(
                TriangulationResult(
                    estimated_lat=lat,
                    estimated_lng=lng,
                    estimated_altitude=alt,
                    accuracy_meters=accuracy,
                    confidence=conf,
                    frequency_mhz=freq,
                    signal_type=common_type,
                    timestamp_utc=utc_now_iso(),
                    contributing_buoys=sorted({d.buoy_id for d in windowed}),
                    tdoa_measurements=measurements,
                    method=method,
                    ellipse_major_m=ellipse[0],
                    ellipse_minor_m=ellipse[1],
                    ellipse_orientation_deg=ellipse[2],
                )
            )
            if common_type == "emergency":
                logger.warning(
                    "EMERGENCY SIGNAL TRIANGULATED: %.3f MHz at (%.6f, %.6f) ±%.1fm",
                    freq, lat, lng, accuracy,
                )
        return results
