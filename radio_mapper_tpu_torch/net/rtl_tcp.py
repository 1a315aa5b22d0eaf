"""rtl_tcp wire-protocol client and server.

Port of ``radio_mapper_tpu/net/rtl_tcp.py`` on the port's
:class:`~radio_mapper_tpu_torch.ingest.sources.IQSource` and
:func:`~radio_mapper_tpu_torch.ops.iq.encode_uint8_iq_numpy`. All of it is
host code; its consumers move the decoded blocks to their device.

Compatibility layer for the reference's distributed raw-IQ transport
(`Code/src/rtl_tcp.c`): a 12-byte ``RTL0`` + tuner-type + gain-count
header followed by a continuous uint8 interleaved I/Q stream, with packed
``{u8 cmd; u32 param}`` control messages (network byte order) from the
client (`rtl_tcp.c:270-365`, command table 0x01-0x0d).

Both ends are implemented:
- :class:`RtlTcpClient` / :class:`RtlTcpSource` let this framework ingest
  from any real rtl_tcp server (an actual dongle on a Pi);
- :class:`RtlTcpServer` serves any :class:`~radio_mapper_tpu_torch.ingest.IQSource`
  to stock rtl_tcp clients (SDR#, gqrx, another buoy) — including the
  simulated scenario sources, which makes full wire-level system tests
  possible without hardware.
"""

from __future__ import annotations

import asyncio
import logging
import socket
import struct
import threading
from typing import Optional

import numpy as np

from radio_mapper_tpu_torch.ingest.sources import IQSource
from radio_mapper_tpu_torch.ops import iq as iq_ops

logger = logging.getLogger(__name__)

MAGIC = b"RTL0"

# Command bytes (`Code/src/rtl_tcp.c:270-365`).
CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_IF_GAIN = 0x06
CMD_SET_TEST_MODE = 0x07
CMD_SET_AGC_MODE = 0x08
CMD_SET_DIRECT_SAMPLING = 0x09
CMD_SET_OFFSET_TUNING = 0x0A
CMD_SET_RTL_XTAL = 0x0B
CMD_SET_TUNER_XTAL = 0x0C
CMD_SET_GAIN_BY_INDEX = 0x0D

TUNER_UNKNOWN, TUNER_E4000, TUNER_FC0012, TUNER_FC0013, TUNER_FC2580, TUNER_R820T, TUNER_R828D = range(7)

_CMD_STRUCT = struct.Struct(">BI")
_HEADER_STRUCT = struct.Struct(">4sII")


def pack_command(cmd: int, param: int) -> bytes:
    return _CMD_STRUCT.pack(cmd, param & 0xFFFFFFFF)


def unpack_command(buf: bytes):
    return _CMD_STRUCT.unpack(buf)


def pack_header(tuner_type: int = TUNER_R820T, gain_count: int = 29) -> bytes:
    return _HEADER_STRUCT.pack(MAGIC, tuner_type, gain_count)


class RtlTcpClient:
    """Blocking rtl_tcp client."""

    def __init__(self, host: str = "127.0.0.1", port: int = 1234, *, timeout_s: float = 10.0):
        self.host = host
        self.port = port
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        header = self._read_exact(12)
        magic, self.tuner_type, self.tuner_gain_count = _HEADER_STRUCT.unpack(header)
        if magic != MAGIC:
            raise IOError(f"not an rtl_tcp server (magic={magic!r})")

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise IOError("rtl_tcp connection closed")
            buf += chunk
        return buf

    def _send(self, cmd: int, param: int):
        self.sock.sendall(pack_command(cmd, param))

    def set_frequency(self, hz: int):
        self._send(CMD_SET_FREQ, int(hz))

    def set_sample_rate(self, hz: int):
        self._send(CMD_SET_SAMPLE_RATE, int(hz))

    def set_gain_mode(self, manual: bool):
        self._send(CMD_SET_GAIN_MODE, int(manual))

    def set_gain(self, tenth_db: int):
        self._send(CMD_SET_GAIN, int(tenth_db))

    def set_freq_correction(self, ppm: int):
        self._send(CMD_SET_FREQ_CORRECTION, int(ppm))

    def set_test_mode(self, on: bool):
        self._send(CMD_SET_TEST_MODE, 1 if on else 0)

    def set_agc_mode(self, on: bool):
        self._send(CMD_SET_AGC_MODE, int(on))

    def set_direct_sampling(self, mode: int):
        self._send(CMD_SET_DIRECT_SAMPLING, int(mode))

    def set_offset_tuning(self, on: bool):
        self._send(CMD_SET_OFFSET_TUNING, int(on))

    def set_gain_by_index(self, index: int):
        self._send(CMD_SET_GAIN_BY_INDEX, int(index))

    def tune(self, freq_hz: int, samp_rate_hz: int, *,
             gain_tenth_db: int = 280, ppm: int = 0):
        """Configure the dongle and return the *achieved* parameters.

        Sends the rtl_tcp commands and mirrors librtlsdr's host-side
        register math (`net/tuner_plan.py`) so callers know the real
        sample rate and LO the hardware settles on — the real rate is
        what converts correlation lags to meters.
        """
        from radio_mapper_tpu_torch.net import tuner_plan

        tuner_names = {TUNER_E4000: "e4000", TUNER_FC0012: "fc0012",
                       TUNER_FC0013: "fc0013", TUNER_FC2580: "fc2580",
                       TUNER_R820T: "r820t", TUNER_R828D: "r828d"}
        tuner = tuner_names.get(self.tuner_type, "r820t")
        plan = tuner_plan.plan_capture(
            freq_hz, samp_rate_hz, gain_tenth_db=gain_tenth_db,
            tuner=tuner, ppm=ppm)
        if ppm:
            self.set_freq_correction(ppm)
        self.set_sample_rate(samp_rate_hz)
        self.set_frequency(freq_hz)
        self.set_gain_mode(True)
        self.set_gain(plan.gain_tenth_db)
        return plan

    def read_iq(self, num_samples: int) -> np.ndarray:
        raw = np.frombuffer(self._read_exact(num_samples * 2), dtype=np.uint8)
        return iq_ops.decode_uint8_iq_numpy(raw).astype(np.complex64)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


class RtlTcpSource(IQSource):
    """IQSource over an rtl_tcp connection."""

    def __init__(self, host: str, port: int = 1234, *, sample_rate_hz: float = 2_048_000.0, center_frequency_hz: float = 121.5e6):
        self.client = RtlTcpClient(host, port)
        self.sample_rate_hz = sample_rate_hz
        self.center_frequency_hz = center_frequency_hz
        self.client.set_sample_rate(int(sample_rate_hz))
        self.client.set_frequency(int(center_frequency_hz))

    def read(self, num_samples: int) -> np.ndarray:
        return self.client.read_iq(num_samples)

    def tune(self, center_frequency_hz: float) -> None:
        super().tune(center_frequency_hz)
        self.client.set_frequency(int(center_frequency_hz))

    def close(self) -> None:
        self.client.close()


class RtlTcpServer:
    """Serve an IQSource over the rtl_tcp protocol (asyncio).

    Equivalent of `rtl_tcp.c`'s ring-buffered sender + command threads
    (`Code/src/rtl_tcp.c:144-365`), with the dongle replaced by any
    IQSource. One client at a time (like the original).
    """

    def __init__(
        self,
        source: IQSource,
        host: str = "127.0.0.1",
        port: int = 1234,
        *,
        chunk_samples: int = 8192,
        tuner_type: int = TUNER_R820T,
        throttle: bool = True,
    ):
        self.source = source
        self.host = host
        self.port = port
        self.chunk_samples = chunk_samples
        self.tuner_type = tuner_type
        self.throttle = throttle
        self._server: Optional[asyncio.AbstractServer] = None
        self.state = {
            "gain_mode": 0, "gain": 0, "agc": 0, "ppm": 0, "test_mode": 0,
            # `librtlsdr.c:1135-1258` mode state
            "direct_sampling": 0, "offset_tuning": 0, "offs_freq_hz": 0,
            "if_gain": {},  # stage -> tenth-dB (rtl_tcp.c:325-329)
            "rtl_xtal_hz": 28_800_000, "tuner_xtal_hz": 28_800_000,
            "freq_hz": 0.0,
        }
        self._test_counter = 0  # continuous 8-bit counter across chunks

    def _apply_tune(self):
        """Route the stored frequency through the current mode, mirroring
        `rtlsdr_set_center_freq` (`librtlsdr.c:888-909`): direct sampling
        tunes the 2832's digital IF (quantized, `librtlsdr.c:704`);
        otherwise the tuner LO is set to freq − offs_freq and the IF stage
        shifts it back — net content unchanged, DC spur displaced."""
        from radio_mapper_tpu_torch.net import tuner_plan

        freq = self.state["freq_hz"]
        if not freq:
            return
        if self.state["direct_sampling"]:
            eff = tuner_plan.plan_if_freq(freq, xtal_hz=self.state["rtl_xtal_hz"])
            self.source.tune(float(eff))
        else:
            # offset tuning's LO shift is compensated digitally; the
            # source (which models content, not spurs) tunes to center.
            self.source.tune(float(freq))

    async def _handle_commands(self, reader: asyncio.StreamReader):
        while True:
            buf = await reader.readexactly(5)
            cmd, param = unpack_command(buf)
            if cmd == CMD_SET_FREQ:
                self.state["freq_hz"] = float(param)
                self._apply_tune()
                logger.info("rtl_tcp: set freq %.6f MHz", param / 1e6)
            elif cmd == CMD_SET_SAMPLE_RATE:
                self.source.sample_rate_hz = float(param)
                logger.info("rtl_tcp: set sample rate %d", param)
            elif cmd == CMD_SET_GAIN_MODE:
                self.state["gain_mode"] = param
            elif cmd == CMD_SET_GAIN:
                self.state["gain"] = param
            elif cmd == CMD_SET_FREQ_CORRECTION:
                self.state["ppm"] = param
            elif cmd == CMD_SET_AGC_MODE:
                self.state["agc"] = param
            elif cmd == CMD_SET_TEST_MODE:
                # RTL2832 test mode: the demod replaces samples with an
                # 8-bit incrementing counter so clients can detect drops
                # (`Code/src/rtl_test.c:109-135` consumes this).
                self.state["test_mode"] = param
                self._test_counter = 0
                logger.info("rtl_tcp: test mode %s", "on" if param else "off")
            elif cmd == CMD_SET_IF_GAIN:
                # param packs (stage << 16) | int16 gain in tenth-dB
                # (`rtl_tcp.c:325-329` → `rtlsdr_set_tuner_if_gain`).
                stage = (param >> 16) & 0xFFFF
                gain = param & 0xFFFF
                if gain >= 0x8000:
                    gain -= 0x10000
                self.state["if_gain"][stage] = gain
                logger.info("rtl_tcp: IF gain stage %d = %.1f dB", stage, gain / 10)
            elif cmd == CMD_SET_DIRECT_SAMPLING:
                # `rtlsdr_set_direct_sampling` (`librtlsdr.c:1145-1240`):
                # tuner bypassed, ADC pin I (1) or Q (2) sampled directly;
                # tuning becomes a digital-IF setting. Retune to apply.
                self.state["direct_sampling"] = int(param)
                setter = getattr(self.source, "set_direct_sampling", None)
                if setter is not None:
                    setter(int(param))
                self._apply_tune()
                logger.info("rtl_tcp: direct sampling mode %d", param)
            elif cmd == CMD_SET_OFFSET_TUNING:
                # `rtlsdr_set_offset_tuning` (`librtlsdr.c:1222-1249`):
                # zero-IF tuners only (returns -2 on R82xx — those use a
                # real IF already); not available in direct mode (-3).
                if self.tuner_type in (TUNER_R820T, TUNER_R828D):
                    logger.warning("rtl_tcp: offset tuning rejected (R82xx)")
                elif self.state["direct_sampling"]:
                    logger.warning("rtl_tcp: offset tuning rejected (direct mode)")
                else:
                    from radio_mapper_tpu_torch.net import tuner_plan

                    on = int(bool(param))
                    self.state["offset_tuning"] = on
                    self.state["offs_freq_hz"] = (
                        tuner_plan.offset_tuning_offs_hz(self.source.sample_rate_hz)
                        if on else 0
                    )
                    self._apply_tune()
                    logger.info(
                        "rtl_tcp: offset tuning %s (offs %d Hz)",
                        "on" if on else "off", self.state["offs_freq_hz"],
                    )
            elif cmd == CMD_SET_RTL_XTAL:
                self.state["rtl_xtal_hz"] = int(param)
            elif cmd == CMD_SET_TUNER_XTAL:
                self.state["tuner_xtal_hz"] = int(param)
            elif cmd == CMD_SET_GAIN_BY_INDEX:
                # `rtl_tcp.c:354-358`: index into the tuner's gain table.
                from radio_mapper_tpu_torch.net.tuner_plan import TUNER_GAINS

                names = {
                    TUNER_E4000: "e4000", TUNER_FC0012: "fc0012",
                    TUNER_FC0013: "fc0013", TUNER_FC2580: "fc2580",
                    TUNER_R820T: "r820t", TUNER_R828D: "r828d",
                }
                gains = TUNER_GAINS.get(names.get(self.tuner_type, ""), ())
                if gains and param < len(gains):
                    self.state["gain"] = gains[param]
                    logger.info("rtl_tcp: gain index %d → %.1f dB", param,
                                self.state["gain"] / 10)
                else:
                    logger.warning("rtl_tcp: gain index %d out of range", param)
            else:
                logger.warning("rtl_tcp: unknown command 0x%02x", cmd)

    async def _handle_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        logger.info("rtl_tcp client connected: %s", peer)
        writer.write(pack_header(self.tuner_type))
        await writer.drain()
        cmd_task = asyncio.create_task(self._handle_commands(reader))
        loop = asyncio.get_event_loop()
        try:
            while True:
                if self.state["test_mode"]:
                    nbytes = self.chunk_samples * 2
                    counter = (self._test_counter + np.arange(nbytes)) & 0xFF
                    self._test_counter = (self._test_counter + nbytes) & 0xFF
                    writer.write(counter.astype(np.uint8).tobytes())
                else:
                    iq = await loop.run_in_executor(None, self.source.read, self.chunk_samples)
                    # numpy encoder: the server is host-side IO — the
                    # torch codec would bounce every chunk through a device.
                    writer.write(iq_ops.encode_uint8_iq_numpy(np.asarray(iq)).tobytes())
                await writer.drain()
                if self.throttle:
                    await asyncio.sleep(self.chunk_samples / self.source.sample_rate_hz)
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        finally:
            cmd_task.cancel()
            writer.close()
            logger.info("rtl_tcp client disconnected: %s", peer)

    async def start(self):
        self._server = await asyncio.start_server(self._handle_client, self.host, self.port)
        # the port actually bound: a request for port 0 gets a free one
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("rtl_tcp server on %s:%d", self.host, self.port)

    async def stop(self):
        if self._server:
            self._server.close()
            await self._server.wait_closed()


def serve_in_thread(server: RtlTcpServer) -> threading.Thread:
    """Run an RtlTcpServer on a dedicated event loop thread (for tests/tools)."""

    started = threading.Event()

    def runner():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def main():
            await server.start()
            started.set()
            await asyncio.Future()

        try:
            loop.run_until_complete(main())
        except (KeyboardInterrupt, RuntimeError):
            pass

    t = threading.Thread(target=runner, daemon=True)
    t.start()
    started.wait(timeout=10)
    return t
