"""Typed config schema (parity: `config.yaml:1-206`).

Port of ``radio_mapper_tpu/config/schema.py``, field for field: the names
are the YAML format both packages read and write.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from radio_mapper_tpu_torch import constants


@dataclasses.dataclass
class LocationConfig:
    latitude: float = 35.55132013715708  # `config.yaml:8-10`
    longitude: float = -97.53221383761282
    altitude: float = 365.76


@dataclasses.dataclass
class GpsConfig:
    enabled: bool = True
    device: str = "/dev/ttyACM0"
    backup_device: str = "/dev/ttyUSB0"
    timeout_seconds: int = 30
    use_fallback_location: bool = True


@dataclasses.dataclass
class BuoyConfig:
    name: str = "Oklahoma City North Buoy"
    location: LocationConfig = dataclasses.field(default_factory=LocationConfig)
    gps: GpsConfig = dataclasses.field(default_factory=GpsConfig)


@dataclasses.dataclass
class SdrConfig:
    device_index: int = 0
    sample_rate: int = constants.DEFAULT_SAMPLE_RATE_HZ
    center_frequency_mhz: float = 121.5
    gain: str = "auto"  # "auto" or dB value as string
    ppm_error: int = 0

    def validate(self):
        if not (
            constants.SDR_MIN_SAMPLE_RATE_HZ
            <= self.sample_rate
            <= constants.SDR_MAX_SAMPLE_RATE_HZ
        ):
            raise ValueError(
                f"sample_rate {self.sample_rate} outside RTL-SDR range "
                f"[{constants.SDR_MIN_SAMPLE_RATE_HZ}, {constants.SDR_MAX_SAMPLE_RATE_HZ}]"
            )


@dataclasses.dataclass
class ServerConfig:
    websocket_url: str = "ws://localhost:8081"
    http_url: str = "http://localhost:4000"
    bind_host: str = "0.0.0.0"
    websocket_port: int = 8081
    http_port: int = 4000


@dataclasses.dataclass
class TimingConfig:
    method: str = "gps"  # gps | ntp | ptp | system
    target_accuracy_microseconds: float = 1.0
    max_acceptable_microseconds: float = 100.0

    def validate(self):
        if self.method not in ("gps", "ntp", "ptp", "system"):
            raise ValueError(f"unknown timing method {self.method!r}")


@dataclasses.dataclass
class ScheduleEntryConfig:
    frequency: float
    duration: int
    type: str = "testing"


@dataclasses.dataclass
class SignalDetectionConfig:
    power_threshold_dbm: float = -70.0
    confidence_threshold: float = 0.6
    emergency_frequencies: List[float] = dataclasses.field(
        default_factory=lambda: list(constants.EMERGENCY_FREQUENCIES_MHZ)
    )
    testing_frequencies: List[float] = dataclasses.field(
        default_factory=lambda: list(constants.TESTING_FREQUENCIES_MHZ)
    )
    scan_ranges: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=lambda: dict(constants.SCAN_RANGES_MHZ)
    )
    fft_size: int = 1024
    overlap: float = 0.5
    correlation_window_seconds: float = 5.0
    priority_schedule: List[ScheduleEntryConfig] = dataclasses.field(
        default_factory=lambda: [
            ScheduleEntryConfig(e.frequency_mhz, int(e.duration_s), e.signal_type)
            for e in constants.DEFAULT_SCAN_SCHEDULE
        ]
    )

    def validate(self):
        if not -150.0 <= self.power_threshold_dbm <= 0.0:
            raise ValueError("power_threshold_dbm out of range")
        if not 0.0 <= self.confidence_threshold <= 1.0:
            raise ValueError("confidence_threshold must be in [0, 1]")
        if self.fft_size & (self.fft_size - 1):
            raise ValueError("fft_size must be a power of two")


@dataclasses.dataclass
class TdoaConfig:
    minimum_buoys: int = 3
    maximum_baseline_km: float = 50.0
    speed_of_light: float = constants.SPEED_OF_LIGHT_M_S
    minimum_snr_db: float = 10.0
    maximum_timing_error_us: float = 10.0
    confidence_threshold: float = 0.7
    # Live waveform GCC-PHAT mode: "auto" prefers snippet correlation and
    # falls back to timestamp differencing; "always" / "never" force.
    waveform_mode: str = "auto"
    # Same-dwell anchor clustering tolerance (see runtime/tdoa_engine.py).
    waveform_anchor_tolerance_s: float = 0.05

    def validate(self):
        if self.minimum_buoys < 3:
            raise ValueError("TDoA triangulation needs at least 3 buoys")
        if self.maximum_baseline_km <= 0:
            raise ValueError("maximum_baseline_km must be positive")
        if self.waveform_mode not in ("auto", "always", "never"):
            raise ValueError(f"unknown waveform_mode {self.waveform_mode!r}")

    def max_lag_samples(self, sample_rate_hz: float) -> int:
        """Correlation window from the maximum baseline (+25% guard)."""
        lag = self.maximum_baseline_km * 1e3 / self.speed_of_light * sample_rate_hz
        return int(lag * 1.25) + 1


@dataclasses.dataclass
class LoggingConfig:
    level: str = "INFO"
    file: str = "radio-mapper.log"
    max_size_mb: int = 100
    backup_count: int = 5
    components: Dict[str, str] = dataclasses.field(
        default_factory=lambda: {
            "sdr": "INFO",
            "gps": "INFO",
            "tdoa": "DEBUG",
            "network": "WARNING",
        }
    )


@dataclasses.dataclass
class StorageConfig:
    max_signals_memory: int = 1000
    save_to_file: bool = True
    data_directory: str = "./data"
    max_age_hours: int = 24
    cleanup_interval_minutes: int = 60


@dataclasses.dataclass
class WebConfig:
    enabled: bool = True
    port: int = 7000
    auto_refresh_seconds: int = 5
    default_zoom: int = 11
    max_zoom: int = 18


@dataclasses.dataclass
class DevelopmentConfig:
    simulate_gps: bool = False
    simulate_signals: bool = True
    debug_timing: bool = False
    mock_sdr: bool = False


@dataclasses.dataclass
class EmergencyConfig:
    auto_alert: bool = True
    alert_methods: List[str] = dataclasses.field(default_factory=lambda: ["console", "log"])
    emergency_confidence_threshold: float = 0.8
    repeat_alert_minutes: int = 5


@dataclasses.dataclass
class TpuConfig:
    """The pipeline's static knobs (no reference equivalent). The section
    keeps the JAX package's name, ``tpu:``, since it is part of the file
    format both packages share."""

    mesh_shape: Optional[Tuple[int, int]] = None  # None = balanced over devices
    num_channels: int = 16  # simultaneous channels per step
    block_len: int = 16_384
    max_peaks: int = 8
    fft_backend: str = "auto"  # auto | xla | matmul
    solver_iterations: int = 40
    solver_starts: int = 1
    gcc_weighting: str = "phat"

    def validate(self):
        if self.fft_backend not in ("auto", "xla", "matmul"):
            raise ValueError(f"unknown fft backend {self.fft_backend!r}")
        if self.gcc_weighting not in ("cc", "phat", "scot", "roth"):
            raise ValueError(f"unknown gcc weighting {self.gcc_weighting!r}")


@dataclasses.dataclass
class Config:
    buoy: BuoyConfig = dataclasses.field(default_factory=BuoyConfig)
    sdr: SdrConfig = dataclasses.field(default_factory=SdrConfig)
    central_server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    timing: TimingConfig = dataclasses.field(default_factory=TimingConfig)
    signal_detection: SignalDetectionConfig = dataclasses.field(
        default_factory=SignalDetectionConfig
    )
    tdoa: TdoaConfig = dataclasses.field(default_factory=TdoaConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    storage: StorageConfig = dataclasses.field(default_factory=StorageConfig)
    web: WebConfig = dataclasses.field(default_factory=WebConfig)
    development: DevelopmentConfig = dataclasses.field(default_factory=DevelopmentConfig)
    emergency: EmergencyConfig = dataclasses.field(default_factory=EmergencyConfig)
    tpu: TpuConfig = dataclasses.field(default_factory=TpuConfig)

    def validate(self) -> "Config":
        """Cross-field validation (parity: `config_manager.py:229-259`)."""
        self.sdr.validate()
        self.timing.validate()
        self.signal_detection.validate()
        self.tdoa.validate()
        self.tpu.validate()
        if not -90.0 <= self.buoy.location.latitude <= 90.0:
            raise ValueError("latitude out of range")
        if not -180.0 <= self.buoy.location.longitude <= 180.0:
            raise ValueError("longitude out of range")
        for port in (self.central_server.websocket_port, self.central_server.http_port, self.web.port):
            if not 1 <= port <= 65535:
                raise ValueError(f"port {port} out of range")
        return self

    def get(self, dotted: str, default=None):
        """Dot-path access, e.g. ``cfg.get("sdr.sample_rate")``
        (parity: `config_manager.py:326-336`)."""
        obj = self
        for part in dotted.split("."):
            if dataclasses.is_dataclass(obj) and hasattr(obj, part):
                obj = getattr(obj, part)
            elif isinstance(obj, dict) and part in obj:
                obj = obj[part]
            else:
                return default
        return obj
