"""IQ sources: a retunable stream of complex64 baseband blocks.

Port of ``radio_mapper_tpu/ingest/sources.py`` (``IQSource``,
``SimulatedSource``, ``FileSource``, ``RtlSdrProcessSource``,
``Rtl2832uSource``) on the
port's :mod:`~radio_mapper_tpu_torch.sim` and :mod:`~radio_mapper_tpu_torch.ops.iq`.
The sources are host code: they return numpy blocks, and the caller moves
them to its device. For the same scenario and seed, ``SimulatedSource``
returns the reference's samples bit for bit (the simulator is the same
numpy code).
"""

from __future__ import annotations

import abc
import subprocess
import threading
import time
from typing import Optional

import numpy as np

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.constants import SPEED_OF_LIGHT_M_S
from radio_mapper_tpu_torch.ops import iq as iq_ops


class IQSource(abc.ABC):
    """A retunable stream of complex64 baseband blocks."""

    sample_rate_hz: float
    center_frequency_hz: float
    # dB to add to 20·log10|FFT| so detection thresholds read on the
    # raw-count "dBm" scale: 0 for uint8-count sources (rtl_sdr, file
    # decode at ±127.5 counts), ~40 for unit-RMS synthetic floats.
    # Detectors read this instead of requiring callers to pass it.
    power_offset_db: float = 0.0

    @abc.abstractmethod
    def read(self, num_samples: int) -> np.ndarray:
        """Blocking read of ``num_samples`` complex64 samples."""

    def tune(self, center_frequency_hz: float) -> None:
        self.center_frequency_hz = float(center_frequency_hz)

    def close(self) -> None:  # pragma: no cover - default no-op
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SimulatedSource(IQSource):
    """Deterministic synthetic stream for one buoy of a scenario.

    Emits the scenario's emitters (true geometric delay, path loss, noise)
    while the tuned frequency lies within half a sample rate of the
    scenario's channel centre, and pure noise otherwise. Time advances with
    every read; two sources for different buoys of the same scenario give
    coherently delayed streams.
    """

    def __init__(
        self,
        scenario: sim.Scenario,
        buoy_index: int,
        *,
        block_cache: int = 1 << 16,
        pps_align_s: Optional[float] = None,
    ):
        """``pps_align_s``: when set, every read starts at the latest
        wall-clock multiple of this period (GPS-PPS-triggered capture: all
        receivers sample the same absolute window, whatever their clock
        reading error). ``None`` keeps the free-running stream."""
        self.scenario = scenario
        self.buoy_index = buoy_index
        self.sample_rate_hz = scenario.sample_rate_hz
        self.center_frequency_hz = scenario.center_frequency_mhz * 1e6
        self._offset = 0
        self._block_cache = block_cache
        self._cache: Optional[np.ndarray] = None
        self._cache_key = None
        self.pps_align_s = pps_align_s
        self.power_offset_db = 40.0  # unit-RMS floats vs raw-count dB

    def _ensure_cache(self):
        on_channel = (
            abs(self.center_frequency_hz - self.scenario.center_frequency_mhz * 1e6)
            <= self.sample_rate_hz / 2
        )
        key = (on_channel, self._block_cache)
        if self._cache_key == key:
            return
        if on_channel:
            scen = sim.Scenario(
                buoys=self.scenario.buoys,
                emitters=self.scenario.emitters,
                sample_rate_hz=self.scenario.sample_rate_hz,
                center_frequency_mhz=self.scenario.center_frequency_mhz,
                block_len=self._block_cache,
                snr_db=self.scenario.snr_db,
                timing_jitter_s=self.scenario.timing_jitter_s,
                seed=self.scenario.seed,
            )
            self._cache = sim.synthesize(scen).iq[self.buoy_index].astype(np.complex64)
        else:
            rng = np.random.default_rng(self.scenario.seed ^ 0xDEAD ^ self.buoy_index)
            n = self._block_cache
            self._cache = ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.01).astype(np.complex64)
        self._cache_key = key

    def read(self, num_samples: int) -> np.ndarray:
        self._ensure_cache()
        n = len(self._cache)
        if self.pps_align_s is not None:
            window = int(time.time() / self.pps_align_s)
            self._offset = int(round(window * self.pps_align_s * self.sample_rate_hz)) % n
        out = np.empty(num_samples, np.complex64)
        pos = 0
        start = self._offset
        while pos < num_samples:
            take = min(num_samples - pos, n - self._offset)
            out[pos : pos + take] = self._cache[self._offset : self._offset + take]
            pos += take
            self._offset = (self._offset + take) % n
        # Tuned off the emitter's centre, a receiver sees the signal shifted
        # in baseband: mix by the offset with a sample-index phase that runs
        # on across reads.
        df = self.scenario.center_frequency_mhz * 1e6 - self.center_frequency_hz
        if df != 0.0 and self._cache_key and self._cache_key[0]:
            idx = start + np.arange(num_samples)
            out = out * np.exp(2j * np.pi * df * idx / self.sample_rate_hz).astype(np.complex64)
        return out

    def window_anchor_ns(self) -> int:
        """True GPS time of the most recent PPS-aligned window start."""
        if self.pps_align_s is None:
            return 0
        return int(int(time.time() / self.pps_align_s) * self.pps_align_s * 1e9)

    def tune(self, center_frequency_hz: float) -> None:
        super().tune(center_frequency_hz)
        self._cache_key = None

    def true_delay_s(self, emitter: int = 0) -> float:
        d = np.linalg.norm(
            self.scenario.buoy_enu()[self.buoy_index]
            - self.scenario.emitter_enu(self.scenario.emitters[emitter])
        )
        return float(d) / SPEED_OF_LIGHT_M_S


class FileSource(IQSource):
    """Replays (and loops) a raw uint8 interleaved I/Q capture file."""

    def __init__(self, path: str, *, sample_rate_hz: float, center_frequency_hz: float = 0.0,
                 loop: bool = True):
        self.path = path
        self.sample_rate_hz = sample_rate_hz
        self.center_frequency_hz = center_frequency_hz
        self.loop = loop
        self._data = iq_ops.load_iq_bin(path).astype(np.complex64)
        if self._data.size == 0:
            raise ValueError(f"empty capture file {path}")
        self._offset = 0

    def read(self, num_samples: int) -> np.ndarray:
        out = np.empty(num_samples, np.complex64)
        n = self._data.size
        pos = 0
        while pos < num_samples:
            if self._offset >= n:
                if not self.loop:
                    out[pos:] = 0
                    break
                self._offset = 0
            take = min(num_samples - pos, n - self._offset)
            out[pos : pos + take] = self._data[self._offset : self._offset + take]
            pos += take
            self._offset += take
        return out


class RtlSdrProcessSource(IQSource):
    """A persistent ``rtl_sdr`` subprocess streaming uint8 I/Q to stdout:
    blocking pipe reads, decoded about 127.5. Retuning restarts the process
    (the command line has no tune command)."""

    def __init__(
        self,
        *,
        sample_rate_hz: float = 2_048_000.0,
        center_frequency_hz: float = 121.5e6,
        gain: Optional[float] = None,
        device_index: int = 0,
        binary: str = "rtl_sdr",
    ):
        self.sample_rate_hz = sample_rate_hz
        self.center_frequency_hz = center_frequency_hz
        self.gain = gain
        self.device_index = device_index
        self.binary = binary
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()

    def _start(self):
        cmd = [
            self.binary,
            "-f", str(int(self.center_frequency_hz)),
            "-s", str(int(self.sample_rate_hz)),
            "-d", str(self.device_index),
        ]
        if self.gain is not None:
            cmd += ["-g", str(self.gain)]
        cmd += ["-"]
        self._proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, stdin=subprocess.DEVNULL,
        )
        time.sleep(0.1)

    def read(self, num_samples: int) -> np.ndarray:
        with self._lock:
            if self._proc is None or self._proc.poll() is not None:
                self._start()
            need = num_samples * 2
            buf = b""
            while len(buf) < need:
                chunk = self._proc.stdout.read(need - len(buf))
                if not chunk:
                    raise IOError("rtl_sdr stream ended")
                buf += chunk
        raw = np.frombuffer(buf, dtype=np.uint8)
        return iq_ops.decode_uint8_iq_numpy(raw).astype(np.complex64)

    def tune(self, center_frequency_hz: float) -> None:
        super().tune(center_frequency_hz)
        with self._lock:
            if self._proc is not None:
                self._proc.terminate()
                self._proc = None

    def close(self) -> None:
        with self._lock:
            if self._proc is not None:
                self._proc.terminate()
                try:
                    self._proc.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
                self._proc = None


class Rtl2832uSource(IQSource):
    """IQ from an in-process :class:`~radio_mapper_tpu_torch.net.usb_proto.
    Rtl2832u` driver — the L0-closed source.

    `RtlSdrProcessSource` and `RtlTcpSource` delegate the USB layer to
    external binaries; this source drives our own driver stack instead
    (`rtlsdr_read_sync` semantics, `Code/src/librtlsdr.c:1643-1659`),
    over whatever transport the driver was opened on: the register-level
    device model in CI (`net/rtl2832u_model.py`), a libusb adapter on
    real hardware. Tuning goes through the real register/PLL planning
    path, so the achieved (quantized) rate and LO are what the stream
    geometry uses. Decode is raw-count scale (power_offset_db = 0), like
    every other uint8 source.
    """

    def __init__(self, dev, *, sample_rate_hz: float = 2_048_000.0,
                 center_frequency_hz: float = 121.5e6):
        self.dev = dev
        # one transport, many threads: RtlTcpServer reads in an executor
        # while its command handler tunes from the event loop — control
        # and bulk transfers must never interleave mid-operation (same
        # guard as RtlSdrProcessSource._lock)
        self._lock = threading.Lock()
        self._sample_rate_hz = 0.0
        self.sample_rate_hz = float(sample_rate_hz)  # programs the dongle
        self._achieved_lo_hz = float(dev.set_center_freq(int(center_frequency_hz)))
        self.center_frequency_hz = float(center_frequency_hz)
        self.power_offset_db = 0.0

    @property
    def sample_rate_hz(self) -> float:
        """The ACHIEVED (resampler-quantized) rate. Assigning programs
        the dongle — rtl_tcp's CMD_SET_SAMPLE_RATE handler assigns
        `source.sample_rate_hz` directly, and the device must follow."""
        return self._sample_rate_hz

    @sample_rate_hz.setter
    def sample_rate_hz(self, hz: float) -> None:
        with self._lock:
            self._sample_rate_hz = float(self.dev.set_sample_rate(int(hz)))

    @property
    def achieved_lo_hz(self) -> float:
        """PLL-quantized LO actually programmed (the frequency-offset
        budget input for coherent correlation)."""
        return self._achieved_lo_hz

    def read(self, num_samples: int) -> np.ndarray:
        # bulk INs may return short on real hardware (librtlsdr's
        # read_sync reports n_read for this reason) — loop until filled
        # so the fixed-shape consumers always get full blocks
        need = 2 * num_samples
        buf = bytearray()
        with self._lock:
            while len(buf) < need:
                chunk = self.dev.read_sync(need - len(buf))
                if not chunk:
                    raise IOError("USB bulk stream ended mid-block")
                buf += chunk
        raw = np.frombuffer(bytes(buf), np.uint8)
        return iq_ops.decode_uint8_iq_numpy(raw).astype(np.complex64)

    def tune(self, center_frequency_hz: float) -> None:
        super().tune(center_frequency_hz)
        with self._lock:
            self._achieved_lo_hz = float(
                self.dev.set_center_freq(int(center_frequency_hz)))

    def close(self) -> None:
        with self._lock:
            self.dev.close()
