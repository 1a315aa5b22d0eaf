"""GPS time and position source with NMEA parsing.

Port of ``radio_mapper_tpu/runtime/gps.py`` (pure host code: importing the
reference's module would load JAX through its package ``__init__``): the
NMEA ``$GPGGA``/``$GPRMC`` parser, a serial reader gated on pyserial, and
``GPSTimeSource`` with its development (simulated lock), hardware (NMEA
fix) and fallback (configured position, system clock) modes.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional, Tuple

from radio_mapper_tpu_torch.runtime.datamodel import utc_now_iso

try:  # pyserial is optional
    import serial  # type: ignore
except ImportError:  # pragma: no cover
    serial = None


def nmea_coord_to_decimal(raw: str, hemi: str) -> Optional[float]:
    """DDMM.MMMM (or DDDMM.MMMM) → signed decimal degrees."""
    if not raw or not hemi:
        return None
    try:
        dot = raw.index(".")
    except ValueError:
        return None
    deg_digits = dot - 2
    if deg_digits <= 0:
        return None
    degrees = int(raw[:deg_digits])
    minutes = float(raw[deg_digits:])
    value = degrees + minutes / 60.0
    if hemi in ("S", "W"):
        value = -value
    return value


@dataclasses.dataclass
class NmeaFix:
    lat: float
    lng: float
    quality: int = 0  # GGA fix quality (0 = invalid)
    num_satellites: int = 0
    altitude_m: Optional[float] = None
    valid: bool = False


def parse_nmea_sentence(line: str) -> Optional[NmeaFix]:
    """Parse a $GPGGA or $GPRMC sentence; None for other/invalid sentences."""
    line = line.strip()
    if not line.startswith("$"):
        return None
    if "*" in line:
        line = line[: line.index("*")]
    parts = line.split(",")
    tag = parts[0][3:] if len(parts[0]) >= 6 else ""
    try:
        if tag == "GGA" and len(parts) >= 10:
            lat = nmea_coord_to_decimal(parts[2], parts[3])
            lng = nmea_coord_to_decimal(parts[4], parts[5])
            quality = int(parts[6] or 0)
            sats = int(parts[7] or 0)
            alt = float(parts[9]) if parts[9] else None
            if lat is None or lng is None:
                return None
            return NmeaFix(lat, lng, quality, sats, alt, valid=quality > 0)
        if tag == "RMC" and len(parts) >= 7:
            status = parts[2]
            lat = nmea_coord_to_decimal(parts[3], parts[4])
            lng = nmea_coord_to_decimal(parts[5], parts[6])
            if lat is None or lng is None:
                return None
            return NmeaFix(lat, lng, quality=1 if status == "A" else 0, valid=status == "A")
    except (ValueError, IndexError):
        return None
    return None


def read_serial_fix(
    device: str, *, baudrates=(9600, 4800, 38400, 115200), timeout_s: float = 2.0
) -> Optional[NmeaFix]:
    """Try to read a valid NMEA fix from a serial GPS (None without
    pyserial)."""
    if serial is None:
        return None
    for baud in baudrates:
        try:
            with serial.Serial(device, baud, timeout=timeout_s) as port:
                deadline = time.time() + timeout_s * 2
                while time.time() < deadline:
                    line = port.readline().decode("ascii", errors="ignore")
                    fix = parse_nmea_sentence(line)
                    if fix and fix.valid:
                        return fix
        except Exception:
            continue
    return None


class GPSTimeSource:
    """Timestamp + position source for a buoy node.

    Modes:
      development — simulated GPS lock: 100 µs timing accuracy and small
        position jitter around the configured location;
      hardware — NMEA fix if a GPS serial device is present;
      fallback — configured coordinates + system clock, with the honest
        degraded accuracy figure (1 ms) rather than the GPS one.
    """

    def __init__(
        self,
        lat: float,
        lng: float,
        *,
        development_mode: bool = False,
        device: Optional[str] = None,
        rng: Optional[random.Random] = None,
        clock_offset_ns: int = 0,
    ):
        """``clock_offset_ns`` simulates this node's clock-reading error:
        it is added to every reported timestamp (the 100 µs-class sync
        error of a development GPS). It models the
        *reading* of the clock only — a GPS PPS edge still aligns capture
        windows at ns scale, which is why waveform TDOA survives it while
        timestamp differencing does not."""
        self.configured_lat = lat
        self.configured_lng = lng
        self.development_mode = development_mode
        self.device = device
        self.gps_locked = False
        self.timing_accuracy_ns = 1_000_000  # 1 ms until locked
        self.lat = lat
        self.lng = lng
        self.clock_offset_ns = int(clock_offset_ns)
        self._rng = rng or random.Random(0xB00F)

    def initialize(self) -> bool:
        if self.development_mode:
            self.gps_locked = True
            self.timing_accuracy_ns = 100_000  # simulated 100 µs
            self.lat = self.configured_lat + self._rng.uniform(-1e-4, 1e-4)
            self.lng = self.configured_lng + self._rng.uniform(-1e-4, 1e-4)
            return True
        if self.device:
            fix = read_serial_fix(self.device)
            if fix and fix.valid:
                self.gps_locked = True
                self.timing_accuracy_ns = 1_000  # PPS-disciplined class
                self.lat, self.lng = fix.lat, fix.lng
                return True
        # Fallback: configured position + system time.
        self.gps_locked = False
        self.timing_accuracy_ns = 1_000_000
        self.lat, self.lng = self.configured_lat, self.configured_lng
        return False

    def get_precise_timestamp(self) -> Tuple[str, int]:
        """(ISO UTC string, epoch nanoseconds).

        The nanosecond value carries this node's simulated clock-reading
        offset so downstream timestamp differencing sees realistic sync
        error."""
        return utc_now_iso(), time.time_ns() + self.clock_offset_ns

    def get_position(self) -> Tuple[float, float]:
        return self.lat, self.lng
