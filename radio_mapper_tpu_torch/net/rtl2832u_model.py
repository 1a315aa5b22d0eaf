"""Register-level software model of an RTL2832U dongle.

The executable stand-in for the physical device behind
:class:`radio_mapper_tpu_torch.net.usb_proto.UsbTransport`: it decodes the
same vendor control transfers the silicon does (block/register writes,
demod page registers, the I2C bridge, EEPROM pointer semantics, the
bulk IQ endpoint with counter test mode) and keeps register state, so
the full librtlsdr-equivalent bring-up/tune/stream protocol in
`usb_proto.py` runs — and is asserted — without hardware.

This plays the role the real dongle plays opposite
`Code/src/librtlsdr.c`; behavioral facts modeled here are cited to the
reference driver's expectations:
  - write strobe in wIndex bit 4, block in wIndex[15:8]
    (`librtlsdr.c:409-434`)
  - demod access via value=(addr<<8)|0x20, index=page(|0x10 write),
    every write chased by a page-0x0a/0x01 status read
    (`librtlsdr.c:522-560`)
  - I2C chips answer only with the repeater on (demod page 1 reg 0x01 =
    0x18, `librtlsdr.c:583`), EXCEPT the EEPROM which hangs off the
    bridge directly (`rtl_eeprom` never touches the repeater,
    `Code/src/rtl_eeprom.c`)
  - tuner identification registers per `Code/include/tuner_*.h`
  - counter test mode: demod page 0 reg 0x19 = 0x03 makes the bulk
    endpoint emit an incrementing uint8 ramp (`librtlsdr.c:1135-1141`,
    consumed by `rtl_test.c:109-135` / `tools/sdr_test.py`)

The model is deliberately strict: transfers to absent I2C addresses or
tuner traffic with the repeater off raise, so driver sequencing bugs
fail tests instead of passing silently.

Port of ``radio_mapper_tpu/net/rtl2832u_model.py``: a copy; its register
files and ``write_log`` equal the JAX package's entry for entry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .usb_proto import (
    Block, ControlTransfer, CTRL_IN, CTRL_OUT, EEPROM_I2C_ADDR, EEPROM_SIZE,
    TransportError, TunerType, TUNER_I2C_ADDR, TUNER_PROBES_PRE_RESET,
    TUNER_PROBES_POST_RESET, UsbDeviceInfo,
)


class I2cChip:
    """A pointered I2C register device: the first written byte sets the
    register pointer; further bytes write sequentially; reads stream
    from the pointer with auto-increment — the semantics both the
    tuner probes and the EEPROM code in the reference rely on."""

    def __init__(self, size: int = 256):
        self.regs = bytearray(size)
        self.pointer = 0

    def write(self, data: bytes) -> None:
        if not data:
            return
        self.pointer = data[0] % len(self.regs)
        for b in data[1:]:
            self.regs[self.pointer] = b
            self.pointer = (self.pointer + 1) % len(self.regs)

    def read(self, length: int) -> bytes:
        out = bytearray()
        for _ in range(length):
            out.append(self.regs[self.pointer])
            self.pointer = (self.pointer + 1) % len(self.regs)
        return bytes(out)


class TunerChip(I2cChip):
    """Tuner-flavoured I2C chip: carries its identification register and
    decodes the driver's LO-plan (reg 0) and gain (reg 1) bursts so
    tests can assert what the 'silicon' was told."""

    def __init__(self, check_reg: int, check_val: int):
        super().__init__(256)
        self.regs[check_reg] = check_val
        self.lo_plans: List[Tuple[int, ...]] = []
        self.gain_writes: List[int] = []

    def write(self, data: bytes) -> None:
        if data and data[0] == 0x00 and len(data) > 1:
            body = data[1:]
            if len(body) % 4 == 0:
                self.lo_plans.append(tuple(
                    int.from_bytes(body[i:i + 4], "little")
                    for i in range(0, len(body), 4)))
                return
        if data and data[0] == 0x01 and len(data) == 3:
            self.gain_writes.append(
                int.from_bytes(data[1:3], "little", signed=True))
            return
        super().write(data)


def open_model_device(tuner: TunerType = TunerType.R820T, **transport_kw):
    """One-call bring-up of a driver on a fresh device model — the
    shared construction for CLI demos, self-tests, and anything else
    that needs a ready `Rtl2832u` without hardware. Returns the opened
    driver (its transport is reachable as ``dev.t``)."""
    from .usb_proto import Rtl2832u

    dev = Rtl2832u(MockRtlUsbTransport(tuner, **transport_kw))
    dev.open()
    return dev


def make_tuner_chip(tuner: TunerType) -> TunerChip:
    """Build a chip whose id register answers the probe for `tuner`."""
    for p in TUNER_PROBES_PRE_RESET + TUNER_PROBES_POST_RESET:
        if p.tuner == tuner:
            # FC2580's probe masks to 7 bits; stored value still matches
            return TunerChip(p.check_reg, p.check_val)
    raise ValueError(f"no probe entry for {tuner!r}")


@dataclasses.dataclass
class TransferStats:
    control_in: int = 0
    control_out: int = 0
    bulk_bytes: int = 0


class MockRtlUsbTransport:
    """The device side of :class:`usb_proto.UsbTransport`."""

    def __init__(self, tuner: Optional[TunerType] = TunerType.R820T, *,
                 eeprom_image: bytes = b"", fail_first_write: bool = False):
        # block register files (sparse; uninitialized regs read 0)
        self.block_regs: Dict[Tuple[int, int], int] = {}
        # demod page registers, byte-granular: (page, addr) -> byte
        self.demod_regs: Dict[Tuple[int, int], int] = {}
        self.i2c: Dict[int, I2cChip] = {}
        self.tuner_chip: Optional[TunerChip] = None
        if tuner is not None and tuner != TunerType.UNKNOWN:
            self.tuner_chip = make_tuner_chip(tuner)
            self.i2c[TUNER_I2C_ADDR[tuner]] = self.tuner_chip
        eeprom = I2cChip(EEPROM_SIZE)
        eeprom.regs[:len(eeprom_image)] = eeprom_image[:EEPROM_SIZE]
        self.i2c[EEPROM_I2C_ADDR] = eeprom
        # pending one-shot stall of the first OUT transfer — exercises
        # the driver's dummy-write/reset recovery (`librtlsdr.c:1493-1496`)
        self._fail_first_write = fail_first_write
        self.resets = 0
        self.stats = TransferStats()
        self.write_log: List[ControlTransfer] = []
        self._test_counter = 0

    # -- helpers --

    @property
    def eeprom(self) -> I2cChip:
        return self.i2c[EEPROM_I2C_ADDR]

    def demod_byte(self, page: int, addr: int) -> int:
        return self.demod_regs.get((page, addr), 0)

    def block_reg(self, block: int, addr: int) -> int:
        return self.block_regs.get((block, addr), 0)

    def repeater_on(self) -> bool:
        return self.demod_byte(1, 0x01) == 0x18

    def testmode_on(self) -> bool:
        return self.demod_byte(0, 0x19) == 0x03

    # -- UsbTransport --

    def reset(self) -> None:
        self.resets += 1
        self._fail_first_write = False

    def control_transfer(self, xfer: ControlTransfer) -> bytes:
        if xfer.request_type == CTRL_OUT:
            self.stats.control_out += 1
            self.write_log.append(xfer)
            if self._fail_first_write:
                self._fail_first_write = False
                raise TransportError("device stalled (pre-reset)")
            return self._handle_out(xfer)
        if xfer.request_type == CTRL_IN:
            self.stats.control_in += 1
            return self._handle_in(xfer)
        raise TransportError(f"bad bmRequestType 0x{xfer.request_type:02x}")

    def bulk_read(self, length: int) -> bytes:
        self.stats.bulk_bytes += length
        if self.testmode_on():
            ramp = (self._test_counter
                    + np.arange(length, dtype=np.int64)) % 256
            self._test_counter = int((self._test_counter + length) % 256)
            return ramp.astype(np.uint8).tobytes()
        # idle ADC: noise-free mid-scale samples
        return bytes([128]) * length

    # -- decode --

    def _is_demod_access(self, xfer: ControlTransfer) -> bool:
        return bool(xfer.value & 0x20) and (xfer.value & 0xFF) in (0x20,)

    def _handle_out(self, xfer: ControlTransfer) -> bytes:
        if not xfer.index & 0x10:
            raise TransportError("OUT transfer without write strobe")
        block = (xfer.index >> 8) & 0xFF
        if block == 0 and self._is_demod_access(xfer):
            # demod write: index = 0x10 | page, value = (addr<<8) | 0x20
            page = xfer.index & 0x0F
            addr = (xfer.value >> 8) & 0xFF
            for off, b in enumerate(xfer.data):
                self.demod_regs[(page, addr + off)] = b
            return b""
        if block == Block.IIC:
            return self._i2c_out(xfer.value & 0xFF, xfer.data)
        # plain block register write: byte-granular, big-endian as sent
        for off, b in enumerate(xfer.data):
            self.block_regs[(block, xfer.value + off)] = b
        return b""

    def _handle_in(self, xfer: ControlTransfer) -> bytes:
        block = (xfer.index >> 8) & 0xFF
        if block == 0 and self._is_demod_access(xfer):
            page = xfer.index & 0x0F
            addr = (xfer.value >> 8) & 0xFF
            # little-endian readback (`librtlsdr.c:484`)
            data = bytes(self.demod_regs.get((page, addr + off), 0)
                         for off in range(xfer.length))
            return data
        if block == Block.IIC:
            return self._i2c_in(xfer.value & 0xFF, xfer.length)
        data = bytes(self.block_regs.get((block, xfer.value + off), 0)
                     for off in range(xfer.length))
        return data

    # -- I2C bridge --

    def _i2c_chip(self, addr: int) -> I2cChip:
        chip = self.i2c.get(addr)
        if chip is None:
            raise TransportError(f"I2C NAK at 0x{addr:02x}")
        if addr != EEPROM_I2C_ADDR and not self.repeater_on():
            raise TransportError(
                f"I2C bridge closed (repeater off) for 0x{addr:02x}")
        return chip

    def _i2c_out(self, addr: int, data: bytes) -> bytes:
        self._i2c_chip(addr).write(data)
        return b""

    def _i2c_in(self, addr: int, length: int) -> bytes:
        return self._i2c_chip(addr).read(length)


class MockUsbBus:
    """A host USB bus model for the enumeration/search API: a mix of
    modeled dongles and non-dongle devices (which enumeration must skip,
    `librtlsdr.c:1288-1291`). Dongle descriptor strings come from the
    same EEPROM image the modeled device carries — as on real silicon,
    where the RTL2832U serves its USB strings from EEPROM."""

    def __init__(self):
        self._devices: List[Tuple[UsbDeviceInfo, Optional[MockRtlUsbTransport]]] = []

    def add_dongle(self, tuner: TunerType, eeprom_image: bytes,
                   **transport_kw) -> MockRtlUsbTransport:
        from radio_mapper_tpu_torch.tools.eeprom import parse_image

        conf = parse_image(eeprom_image)
        transport = MockRtlUsbTransport(tuner, eeprom_image=eeprom_image,
                                        **transport_kw)
        info = UsbDeviceInfo(conf.vendor_id, conf.product_id,
                             conf.manufacturer, conf.product, conf.serial)
        self._devices.append((info, transport))
        return transport

    def add_other_device(self, vid: int, pid: int, product: str = "") -> None:
        """A non-RTL device on the bus (hub, keyboard, ...)."""
        self._devices.append(
            (UsbDeviceInfo(vid, pid, product=product), None))

    # -- UsbBus --

    def devices(self) -> List[UsbDeviceInfo]:
        return [info for info, _ in self._devices]

    def open(self, bus_slot: int) -> MockRtlUsbTransport:
        # strict bounds: a negative error code (device_search -1,
        # get_index_by_serial -2/-3) passed straight in must fail, not
        # silently open self._devices[-1]
        if not 0 <= bus_slot < len(self._devices):
            raise TransportError(f"no device at bus slot {bus_slot}")
        info, transport = self._devices[bus_slot]
        if transport is None:
            raise TransportError(
                f"device at slot {bus_slot} ({info.product!r}) is not a "
                "modeled dongle")
        return transport
