"""Constants the ported slice uses, copied from the JAX package, with the
scan schedule and the band classifier of the buoy service.

Values and functions equal ``radio_mapper_tpu/constants.py`` and
``ops/iq.py`` (``UINT8_OFFSET``); tests assert the equality.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# --- Physics
SPEED_OF_LIGHT_M_S = 299_792_458.0
EARTH_RADIUS_M = 6_378_137.0  # the spherical Earth of the central engine

# --- WGS84 ellipsoid (geo.lat_lng_to_enu_np)
WGS84_A = 6_378_137.0
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)

# --- RTL-SDR envelope
SDR_MIN_SAMPLE_RATE_HZ = 225_000
SDR_MAX_SAMPLE_RATE_HZ = 3_200_000
SDR_LOSSLESS_MAX_RATE_HZ = 2_400_000
DEFAULT_SAMPLE_RATE_HZ = 2_048_000

# --- Detection defaults
DEFAULT_DETECTION_THRESHOLD_DBM = -70.0
DEFAULT_CONFIDENCE_FLOOR = 0.3
DEFAULT_SNR_FULLSCALE_DB = 20.0  # confidence = SNR / 20, clipped to [0, 1]
DEFAULT_DC_NOTCH_HZ = 10_000.0  # skip ±10 kHz around the tuned center
DEFAULT_PEAK_MIN_DISTANCE_BINS = 10
DEFAULT_BLOCK_SAMPLES = 16_384
STREAM_BLOCK_SAMPLES = 8_192

# --- Emergency / testing frequencies (MHz) and the bands a buoy scans
EMERGENCY_FREQUENCIES_MHZ: Tuple[float, ...] = (121.5, 243.0, 406.025, 156.8, 462.675)
TESTING_FREQUENCIES_MHZ: Tuple[float, ...] = (105.7, 101.9)
SCAN_RANGES_MHZ = {
    "aviation": (118.0, 136.0),
    "public_safety": (155.0, 160.0),
    "amateur_2m": (144.0, 148.0),
    "amateur_70cm": (420.0, 450.0),
    "fm_broadcast": (88.0, 108.0),
}

# --- uint8 IQ decode offset (dongle bytes are centered at 127.5)
UINT8_OFFSET = 127.5

# --- TDOA engine defaults (the central node's grouping and solve gates)
DEFAULT_MIN_BUOYS = 3
DEFAULT_MAX_BASELINE_KM = 50.0
DEFAULT_FREQ_TOLERANCE_MHZ = 0.01
DEFAULT_CORRELATION_WINDOW_S = 10.0
CENTRAL_CORRELATION_WINDOW_S = 5.0


@dataclasses.dataclass(frozen=True)
class ScheduleEntry:
    """One dwell in the GPS-synchronized frequency scan schedule."""

    frequency_mhz: float
    duration_s: float
    signal_type: str


# The 35-second synchronized cycle every buoy follows.
DEFAULT_SCAN_SCHEDULE: Tuple[ScheduleEntry, ...] = (
    ScheduleEntry(105.7, 5.0, "testing"),
    ScheduleEntry(121.5, 10.0, "emergency"),
    ScheduleEntry(243.0, 10.0, "emergency"),
    ScheduleEntry(156.8, 5.0, "emergency"),
    ScheduleEntry(101.9, 5.0, "testing"),
)


def schedule_cycle_s(schedule: Tuple[ScheduleEntry, ...] = DEFAULT_SCAN_SCHEDULE) -> float:
    return float(sum(e.duration_s for e in schedule))


def frequency_at(t_unix_s: float, schedule: Tuple[ScheduleEntry, ...] = DEFAULT_SCAN_SCHEDULE) -> ScheduleEntry:
    """Dwell active at wall-clock time ``t``: every node indexes the
    schedule by ``int(t) % cycle``, so all tune identically."""
    cycle = schedule_cycle_s(schedule)
    pos = int(t_unix_s) % int(cycle)
    elapsed = 0.0
    for entry in schedule:
        if elapsed <= pos < elapsed + entry.duration_s:
            return entry
        elapsed += entry.duration_s
    return schedule[0]


def classify_frequency_mhz(frequency_mhz: float) -> str:
    """Band classification used to tag detections."""
    if frequency_mhz in (121.5, 243.0):
        return "emergency"
    if 118.0 <= frequency_mhz <= 136.0:
        return "aviation"
    if 144.0 <= frequency_mhz <= 148.0:
        return "amateur"
    if 156.0 <= frequency_mhz <= 162.0:
        return "marine"
    if 406.0 <= frequency_mhz <= 406.1:
        return "emergency_beacon"
    return "unknown"


def classification_label(frequency_mhz: float, signal_type: str) -> str:
    """Human-readable label for the API layer."""
    if signal_type == "emergency":
        if abs(frequency_mhz - 121.5) < 0.001:
            return "Aviation Emergency - 121.5 MHz"
        if abs(frequency_mhz - 243.0) < 0.001:
            return "Military Emergency - 243.0 MHz"
        return "Emergency Frequency"
    labels = {
        "public_safety": "Public Safety Radio",
        "aviation": "Aviation Communication",
        "amateur": "Amateur Radio",
        "fm_radio": "FM Radio Broadcast",
    }
    return labels.get(signal_type, f"{signal_type.title()} Signal")
