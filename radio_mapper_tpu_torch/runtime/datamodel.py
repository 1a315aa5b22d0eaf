"""The records the central TDOA engine and the buoy service read and
write, and the buoy's wire helpers.

Copies of ``radio_mapper_tpu/runtime/datamodel.py``'s ``BuoyPosition``,
``SignalDetection``, ``LiveSignalDetection`` (the central service's
record, built from the wire), ``TDoAMeasurement``, ``TriangulationResult``,
``TriangulatedSignal`` (the API's fix record), ``BuoyStatus`` and
``UserSignalRequest``, and of its wire helpers (``utc_now_iso``, ``parse_iso``,
``NumpyJSONEncoder``, ``to_json``, the IQ snippet codecs
``encode_iq_wire``/``decode_iq_wire`` and ``detection_wire_dict``):
importing the reference's module would load JAX through its package
``__init__``. Tests assert that the field names, types and defaults and
the wire bytes equal the reference's.
"""

from __future__ import annotations

import base64
import dataclasses
import json
from datetime import datetime, timezone
from typing import Any, Dict, List, Optional

import numpy as np


def utc_now_iso() -> str:
    return datetime.now(timezone.utc).isoformat()


def parse_iso(ts: str) -> datetime:
    """Tolerant ISO parse (accepts a trailing 'Z')."""
    return datetime.fromisoformat(ts.replace("Z", "+00:00"))


class NumpyJSONEncoder(json.JSONEncoder):
    """JSON encoder for numpy scalars and arrays, datetimes and complex IQ
    snippets (as ``[re, im]`` pairs)."""

    def default(self, obj):
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, (np.integer,)):
            return int(obj)
        if isinstance(obj, (np.floating,)):
            return float(obj)
        if isinstance(obj, np.ndarray):
            if np.iscomplexobj(obj):
                return [[float(v.real), float(v.imag)] for v in obj]
            return obj.tolist()
        if isinstance(obj, (complex, np.complexfloating)):
            return [float(obj.real), float(obj.imag)]
        if isinstance(obj, datetime):
            return obj.isoformat()
        return super().default(obj)


def to_json(obj: Any) -> str:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    return json.dumps(obj, cls=NumpyJSONEncoder)


# IQ snippets travel as base64 of interleaved I/Q: "u8" (uint8 about 127.5
# with a per-snippet scale, the dongle's own 8 bits), "f16" (half floats),
# or "json" (float pairs, the format a message without ``iq_format`` has).
IQ_WIRE_FORMATS = ("json", "u8", "f16")


def encode_iq_wire(iq, fmt: str = "u8"):
    """Encode a complex snippet for the wire: ``(samples, extra)``, the
    message's ``iq_samples`` value and the ``iq_format`` (plus ``iq_scale``
    for "u8") keys to merge into the message."""
    arr = np.asarray(iq, np.complex64)
    inter = np.empty(2 * arr.size, np.float32)
    inter[0::2] = arr.real
    inter[1::2] = arr.imag
    if fmt == "u8":
        scale = float(np.max(np.abs(inter))) or 1.0
        q = np.clip(np.round(inter / scale * 127.5 + 127.5), 0, 255).astype(np.uint8)
        return base64.b64encode(q.tobytes()).decode("ascii"), {"iq_format": "u8", "iq_scale": scale}
    if fmt == "f16":
        return base64.b64encode(inter.astype(np.float16).tobytes()).decode("ascii"), {"iq_format": "f16"}
    if fmt == "json":
        return [[float(v.real), float(v.imag)] for v in arr], {"iq_format": "json"}
    raise ValueError(f"unknown iq wire format {fmt!r} (want one of {IQ_WIRE_FORMATS})")


def decode_iq_wire(samples, fmt: Optional[str] = None, scale: float = 1.0) -> np.ndarray:
    """Decode a wire ``iq_samples`` payload back to complex64."""
    if fmt in (None, "json"):
        return np.asarray(
            [complex(v[0], v[1]) if isinstance(v, (list, tuple)) else complex(v) for v in samples],
            np.complex64,
        )
    raw = base64.b64decode(samples)
    if fmt == "u8":
        inter = (np.frombuffer(raw, np.uint8).astype(np.float32) - 127.5) / 127.5
        inter = inter * np.float32(scale or 1.0)
    elif fmt == "f16":
        inter = np.frombuffer(raw, np.float16).astype(np.float32)
    else:
        raise ValueError(f"unknown iq wire format {fmt!r}")
    return (inter[0::2] + 1j * inter[1::2]).astype(np.complex64)


def detection_wire_dict(det: "SignalDetection", iq_format: str = "u8") -> Dict:
    """``asdict(det)`` with the snippet encoded for the wire."""
    d = dataclasses.asdict(det)
    if det.iq_samples is not None and len(det.iq_samples):
        samples, extra = encode_iq_wire(det.iq_samples, iq_format)
        d["iq_samples"] = samples
        d.update(extra)
    return d


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
class LiveSignalDetection:
    """The central service's detection record."""

    node_id: str
    frequency_mhz: float
    signal_strength_dbm: float
    timestamp_utc: str
    gps_timestamp_ns: int
    lat: float
    lng: float
    confidence: float
    signal_type: str
    bandwidth_hz: float = 10_000.0
    detection_method: str = "unknown"
    iq_samples: Optional[List[complex]] = None
    iq_sample_rate_hz: float = 0.0
    iq_anchor_ns: int = 0

    @classmethod
    def from_message(cls, data: Dict) -> "LiveSignalDetection":
        """Build from a wire dict, tolerating buoy-style field names
        (``buoy_id``) and decoding an encoded IQ snippet."""
        d = dict(data)
        if "buoy_id" in d:
            d["node_id"] = d.pop("buoy_id")
        d.setdefault("bandwidth_hz", 10_000.0)
        for unwanted in ("iq_sample_file", "correlation_id"):
            d.pop(unwanted, None)
        fmt = d.pop("iq_format", None)
        scale = d.pop("iq_scale", 1.0)
        if d.get("iq_samples") is not None and len(d["iq_samples"]):
            d["iq_samples"] = decode_iq_wire(d["iq_samples"], fmt, scale)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


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


@dataclasses.dataclass
class TriangulatedSignal:
    """The API's triangulated signal record."""

    signal_id: str
    frequency_mhz: float
    estimated_lat: float
    estimated_lng: float
    confidence: float
    detected_by: List[str]
    detection_timestamps: List[str]
    signal_type: str
    triangulation_method: str
    accuracy_meters: float
    # 1σ horizontal error ellipse (see TriangulationResult)
    ellipse_major_m: float = 0.0
    ellipse_minor_m: float = 0.0
    ellipse_orientation_deg: float = 0.0


@dataclasses.dataclass
class BuoyStatus:
    """A buoy's heartbeat payload."""

    buoy_id: str
    lat: float
    lng: float
    gps_locked: bool
    timing_accuracy_ns: int
    sdr_active: bool
    last_detection: Optional[str]
    uptime_seconds: float
    signals_detected: int


@dataclasses.dataclass
class UserSignalRequest:
    """A frequency-search request."""

    request_id: str
    frequency_mhz: float
    bandwidth_khz: float = 12.5
    duration_seconds: float = 30.0
    priority: str = "normal"
    timestamp_utc: str = ""
