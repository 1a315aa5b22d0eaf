"""SDR health benchmark: sample-drop detection and sample-clock PPM error.

Capability parity with the reference's `rtl_test` tool
(`Code/src/rtl_test.c`): its two measurements are (a) lost-sample
detection by enabling the RTL2832's test mode, which replaces samples
with an 8-bit incrementing counter, and checking the received stream for
counter discontinuities (`rtl_test.c:109-135`), and (b) a sample-clock
error benchmark that counts delivered samples against CLOCK_MONOTONIC and
reports the deviation from the nominal rate in PPM (`rtl_test.c:137-213`).

Here both run against any byte/IQ transport the framework speaks — the
rtl_tcp protocol (real dongle behind `rtl_tcp`, or this framework's own
`RtlTcpServer`) or the native C++ ingest ring — so the same tool
qualifies hardware, network transports, and replay sources.

Port of ``radio_mapper_tpu/tools/sdr_test.py`` on the port's
:class:`~radio_mapper_tpu_torch.net.rtl_tcp.RtlTcpClient`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class DropStats:
    """Running tally of 8-bit counter discontinuities in a byte stream."""

    total_bytes: int = 0
    lost_bytes: int = 0
    gaps: int = 0
    _last: Optional[int] = field(default=None, repr=False)

    def update(self, block: np.ndarray) -> None:
        """Feed the next received block (uint8 counter-mode bytes)."""
        block = np.asarray(block, np.uint8)
        if block.size == 0:
            return
        self.total_bytes += int(block.size)
        if self._last is not None:
            first_gap = int((int(block[0]) - self._last - 1) % 256)
            if first_gap:
                self.gaps += 1
                self.lost_bytes += first_gap
        if block.size > 1:
            # (b[i+1] - b[i]) mod 256 should be 1 everywhere; anything else
            # is `diff - 1` bytes lost (same modular math as rtl_test.c:121).
            diff = (block[1:].astype(np.int16) - block[:-1].astype(np.int16) - 1) % 256
            bad = diff != 0
            self.gaps += int(np.count_nonzero(bad))
            self.lost_bytes += int(diff[bad].sum())
        self._last = int(block[-1])

    @property
    def loss_ratio(self) -> float:
        sent = self.total_bytes + self.lost_bytes
        return self.lost_bytes / sent if sent else 0.0


@dataclass
class PpmResult:
    nominal_rate_hz: float
    measured_rate_hz: float
    ppm_error: float
    duration_s: float
    total_samples: int


def measure_ppm(
    read_samples,
    *,
    nominal_rate_hz: float,
    duration_s: float = 10.0,
    block_samples: int = 8192,
    warmup_blocks: int = 2,
) -> PpmResult:
    """Count delivered samples against the monotonic clock.

    ``read_samples(n)`` must return an array with one entry per sample
    (complex IQ or real); blocking semantics like `rtl_test.c`'s async
    callback. A couple of warmup blocks absorb connection/filter
    start-up transients, mirroring rtl_test's first-interval skip
    (`rtl_test.c:176-183`).
    """
    for _ in range(warmup_blocks):
        read_samples(block_samples)
    total = 0
    t0 = time.monotonic()
    while True:
        got = read_samples(block_samples)
        total += int(np.asarray(got).shape[-1]) if hasattr(got, "shape") else len(got)
        elapsed = time.monotonic() - t0
        if elapsed >= duration_s:
            break
    measured = total / elapsed
    ppm = (measured - nominal_rate_hz) / nominal_rate_hz * 1e6
    return PpmResult(
        nominal_rate_hz=nominal_rate_hz,
        measured_rate_hz=measured,
        ppm_error=ppm,
        duration_s=elapsed,
        total_samples=total,
    )


def run_drop_test(
    read_bytes,
    *,
    duration_s: float = 5.0,
    block_bytes: int = 16384,
    max_lock_blocks: int = 64,
) -> DropStats:
    """Drive a counter-mode byte reader for ``duration_s`` and tally drops.

    The test-mode command races the in-flight IQ stream (true of real
    rtl_tcp too), so blocks are discarded until one is internally a clean
    8-bit counter; only then does accounting start. Raises if the stream
    never locks (test mode not honored).
    """
    stats = DropStats()
    for _ in range(max_lock_blocks):
        block = np.asarray(read_bytes(block_bytes), np.uint8)
        diff = (block[1:].astype(np.int16) - block[:-1].astype(np.int16)) % 256
        if block.size > 1 and np.all(diff == 1):
            stats.update(block)
            break
    else:
        raise RuntimeError("stream never entered counter test mode")
    t0 = time.monotonic()
    while time.monotonic() - t0 < duration_s:
        stats.update(read_bytes(block_bytes))
    return stats


def sdr_test_rtl_tcp(
    host: str,
    port: int,
    *,
    sample_rate_hz: float = 2_048_000.0,
    drop_seconds: float = 5.0,
    ppm_seconds: float = 10.0,
) -> dict:
    """Full rtl_test-equivalent run over an rtl_tcp connection.

    Enables the dongle/server test mode for the drop check, then disables
    it and measures the delivered sample rate against the wall clock.
    Returns a JSON-ready dict.
    """
    from radio_mapper_tpu_torch.net.rtl_tcp import RtlTcpClient

    client = RtlTcpClient(host, port)
    try:
        client.set_sample_rate(int(sample_rate_hz))
        client.set_test_mode(True)

        def read_bytes(n):
            return np.frombuffer(client._read_exact(n), dtype=np.uint8)

        drops = run_drop_test(read_bytes, duration_s=drop_seconds)
        client.set_test_mode(False)
        # Flush one block so counter bytes don't pollute the rate window.
        client.read_iq(8192)
        ppm = measure_ppm(
            client.read_iq,
            nominal_rate_hz=sample_rate_hz,
            duration_s=ppm_seconds,
        )
    finally:
        client.close()
    return {
        "drop_test": {
            "total_bytes": drops.total_bytes,
            "lost_bytes": drops.lost_bytes,
            "gaps": drops.gaps,
            "loss_ratio": drops.loss_ratio,
        },
        "ppm_test": {
            "nominal_rate_hz": ppm.nominal_rate_hz,
            "measured_rate_hz": ppm.measured_rate_hz,
            "ppm_error": ppm.ppm_error,
            "duration_s": ppm.duration_s,
            "total_samples": ppm.total_samples,
        },
    }
