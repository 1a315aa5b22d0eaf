"""The records the central TDOA engine reads and writes.

Copies of ``radio_mapper_tpu/runtime/datamodel.py``'s ``BuoyPosition``,
``SignalDetection``, ``TDoAMeasurement`` and ``TriangulationResult`` and
of ``utc_now_iso``: importing the reference's module would load JAX
through its package ``__init__``. A test asserts that the field names,
types and defaults equal the reference's.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timezone
from typing import Any, List, Optional


def utc_now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


@dataclasses.dataclass
class BuoyPosition:
    buoy_id: str
    lat: float
    lng: float
    altitude: float = 0.0
    timing_accuracy_ns: int = 100_000


@dataclasses.dataclass
class SignalDetection:
    """One detection event from one buoy.

    The ``iq_*`` fields carry the waveform snippet of the engine's waveform
    mode: ``iq_samples`` (complex baseband around the detection),
    ``iq_sample_rate_hz`` (0 ⇒ no snippet) and ``iq_anchor_ns`` (GPS time
    of the snippet's first sample, used only to group snippets of the same
    dwell).
    """

    buoy_id: str
    frequency_mhz: float
    signal_strength_dbm: float
    timestamp_utc: str
    gps_timestamp_ns: int
    lat: float
    lng: float
    confidence: float
    signal_type: str = "unknown"
    iq_samples: Optional[Any] = None  # ndarray or list of complex
    iq_sample_rate_hz: float = 0.0
    iq_anchor_ns: int = 0


@dataclasses.dataclass
class TDoAMeasurement:
    buoy1_id: str
    buoy2_id: str
    time_difference_ns: int  # buoy2 − buoy1; positive ⇒ buoy2 later
    distance_difference_m: float
    confidence: float
    frequency_mhz: float


@dataclasses.dataclass
class TriangulationResult:
    estimated_lat: float
    estimated_lng: float
    estimated_altitude: float
    accuracy_meters: float
    confidence: float
    frequency_mhz: float
    signal_type: str
    timestamp_utc: str
    contributing_buoys: List[str]
    tdoa_measurements: List[TDoAMeasurement]
    method: str  # "hyperbolic-lm", "gcc-phat+lm", ...
    # 1σ horizontal error ellipse from the solver's covariance; the
    # orientation is the major axis's bearing, degrees clockwise from
    # North, in [0, 180)
    ellipse_major_m: float = 0.0
    ellipse_minor_m: float = 0.0
    ellipse_orientation_deg: float = 0.0
