"""RTL2832U USB control-transfer protocol and register driver.

This module implements the *entire software half* of the reference's
librtlsdr core (`Code/src/librtlsdr.c`): the vendor control-transfer
framing, the block/register address map, demod-page register access, the
I2C-over-USB bridge, EEPROM access, FIR packing, baseband init, the
tuner probe/open state machine, and every device-mode setter
(sample rate, IF, test mode, AGC, direct sampling, offset tuning).

The ONE thing it does not contain is a physical USB endpoint: all
traffic goes through an abstract :class:`UsbTransport` whose single
required primitive maps 1:1 onto ``libusb_control_transfer``
(`Code/src/librtlsdr.c:409-421`). A libusb-, uvc-, or kernel-backed
transport is a ~10-line adapter; this repo ships
:class:`~radio_mapper_tpu_torch.net.rtl2832u_model.MockRtlUsbTransport`, a
register-level software model of the dongle, so the full open→init→
probe→tune→stream protocol executes (and is asserted) in CI with no
hardware.

Protocol facts (addresses, magic values, write sequences) are hardware
constants and therefore match the reference bit-for-bit — that is the
point. The *structure* is original: a pure encoder layer
(:func:`encode_read_array` / :func:`encode_write_array`), a transport
interface, and a stateless-where-possible driver class, instead of the
reference's 1944-line C translation unit. Frequency/rate *planning*
math lives in :mod:`radio_mapper_tpu_torch.net.tuner_plan`; this module turns
plans into register traffic.

Reference citations (the librtlsdr sources):
  - control framing: `Code/src/librtlsdr.c:409-434` (read/write_array),
    `:476-520` (read/write_reg), `:522-560` (demod regs)
  - I2C bridge: `Code/src/librtlsdr.c:435-474`; repeater `:583`
  - FIR packing: `Code/src/librtlsdr.c:584-614`, defaults `:92-95`
  - baseband init: `Code/src/librtlsdr.c:616-676`
  - IF/ppm/sample-rate regs: `Code/src/librtlsdr.c:690-727, 1075-1126`
  - mode setters: `Code/src/librtlsdr.c:1135-1258`
  - EEPROM: `Code/src/librtlsdr.c:825-886`
  - open/probe: `Code/src/librtlsdr.c:1407-1602`
  - tuner check registers: `Code/include/tuner_{e4k,fc0012,fc0013,
    fc2580,r82xx}.h`

Port of ``radio_mapper_tpu/net/usb_proto.py``: a copy; the register
traffic equals the JAX package's transfer for transfer.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

from . import tuner_plan

log = logging.getLogger(__name__)

# --- vendor-request framing (`librtlsdr.c:364-368`) -------------------------

CTRL_IN = 0xC0   # LIBUSB_REQUEST_TYPE_VENDOR | LIBUSB_ENDPOINT_IN
CTRL_OUT = 0x40  # LIBUSB_REQUEST_TYPE_VENDOR | LIBUSB_ENDPOINT_OUT
CTRL_TIMEOUT_MS = 300
BULK_ENDPOINT = 0x81  # `librtlsdr.c:1658`

EEPROM_I2C_ADDR = 0xA0  # `librtlsdr.c:370`
EEPROM_SIZE = 256


class Block(enum.IntEnum):
    """Register blocks — upper byte of wIndex (`librtlsdr.c:399-407`)."""

    DEMOD = 0
    USB = 1
    SYS = 2
    TUN = 3
    ROM = 4
    IR = 5
    IIC = 6


class UsbReg(enum.IntEnum):
    """USB-block registers (`librtlsdr.c:372-381`)."""

    SYSCTL = 0x2000
    CTRL = 0x2010
    STAT = 0x2014
    EPA_CFG = 0x2144
    EPA_CTL = 0x2148
    EPA_MAXPKT = 0x2158
    EPA_MAXPKT_2 = 0x215A
    EPA_FIFO_CFG = 0x2160


class SysReg(enum.IntEnum):
    """System-block registers (`librtlsdr.c:383-397`)."""

    DEMOD_CTL = 0x3000
    GPO = 0x3001
    GPI = 0x3002
    GPOE = 0x3003
    GPD = 0x3004
    SYSINTE = 0x3005
    SYSINTS = 0x3006
    GP_CFG0 = 0x3007
    GP_CFG1 = 0x3008
    SYSINTE_1 = 0x3009
    SYSINTS_1 = 0x300A
    DEMOD_CTL_1 = 0x300B
    IR_SUSPEND = 0x300C


@dataclasses.dataclass(frozen=True)
class ControlTransfer:
    """One vendor control transfer — the wire unit of the whole driver.

    Mirrors the ``libusb_control_transfer`` argument tuple the reference
    builds at `librtlsdr.c:414` / `:426`: bRequest is always 0; wValue
    carries the register address; wIndex carries block and direction.
    """

    request_type: int          # CTRL_IN or CTRL_OUT
    value: int                 # wValue: register address
    index: int                 # wIndex: (block << 8) | (0x10 if write)
    data: bytes = b""          # OUT payload
    length: int = 0            # IN expected length

    @property
    def is_read(self) -> bool:
        return self.request_type == CTRL_IN


def encode_read_array(block: int, addr: int, length: int) -> ControlTransfer:
    """IN transfer: wIndex = block << 8 (`librtlsdr.c:409-421`)."""
    return ControlTransfer(CTRL_IN, addr & 0xFFFF, (block << 8), length=length)


def encode_write_array(block: int, addr: int, data: bytes) -> ControlTransfer:
    """OUT transfer: wIndex = (block << 8) | 0x10 (`librtlsdr.c:423-434`).

    The 0x10 bit in wIndex is the RTL2832U's write strobe.
    """
    return ControlTransfer(CTRL_OUT, addr & 0xFFFF, (block << 8) | 0x10,
                           data=bytes(data))


def encode_reg_value(val: int, length: int) -> bytes:
    """Register value byte order (`librtlsdr.c:505-512`): 1-byte writes
    send ``val & 0xff``; 2-byte writes send big-endian (hi, lo)."""
    if length == 1:
        return bytes([val & 0xFF])
    return bytes([(val >> 8) & 0xFF, val & 0xFF])


def decode_reg_value(data: bytes) -> int:
    """Register read decode (`librtlsdr.c:484`): little-endian
    ``(data[1] << 8) | data[0]`` — note the read/write asymmetry is the
    hardware's, not ours."""
    if len(data) == 1:
        return data[0]
    return (data[1] << 8) | data[0]


# --- FIR (`librtlsdr.c:77, 92-95, 584-614`) ---------------------------------

FIR_LEN = 16
# default baseband FIR: 8 × int8 taps then 8 × int12 taps
FIR_DEFAULT: Tuple[int, ...] = (
    -54, -36, -41, -40, -32, -14, 14, 53,
    101, 156, 215, 273, 327, 372, 404, 421,
)


def pack_fir(coeffs: Sequence[int] = FIR_DEFAULT) -> bytes:
    """Pack 16 FIR taps into the demod's 20-byte register image
    (`rtlsdr_set_fir`, `librtlsdr.c:584-614`): taps 0-7 are int8, taps
    8-15 are int12 packed 2-per-3-bytes. Raises on range overflow, as
    the reference returns -1."""
    if len(coeffs) != FIR_LEN:
        raise ValueError(f"FIR needs {FIR_LEN} taps, got {len(coeffs)}")
    out = bytearray(20)
    for i in range(8):
        v = coeffs[i]
        if not -128 <= v <= 127:
            raise ValueError(f"int8 FIR tap {i} out of range: {v}")
        out[i] = v & 0xFF
    for i in range(0, 8, 2):
        v0, v1 = coeffs[8 + i], coeffs[8 + i + 1]
        if not (-2048 <= v0 <= 2047 and -2048 <= v1 <= 2047):
            raise ValueError(f"int12 FIR taps {8+i},{9+i} out of range")
        base = 8 + i * 3 // 2
        out[base] = (v0 >> 4) & 0xFF
        out[base + 1] = ((v0 << 4) | ((v1 >> 8) & 0x0F)) & 0xFF
        out[base + 2] = v1 & 0xFF
    return bytes(out)


# --- tuner probe table ------------------------------------------------------


class TunerType(enum.IntEnum):
    """Matches the reference enum order (`rtl-sdr.h` / `librtlsdr.c:268`)
    so rtl_tcp header tuner ids interoperate."""

    UNKNOWN = 0
    E4000 = 1
    FC0012 = 2
    FC0013 = 3
    FC2580 = 4
    R820T = 5
    R828D = 6


@dataclasses.dataclass(frozen=True)
class TunerProbe:
    tuner: TunerType
    i2c_addr: int
    check_reg: int
    check_val: int
    mask: int = 0xFF


# Probe order IS part of the protocol: FC0013 and FC0012 share I2C
# address 0xc6 and are told apart only by the check value, and the
# FC2580/FC0012 probes happen after a GPIO5 tuner reset
# (`librtlsdr.c:1504-1552`). Check constants from the tuner headers.
TUNER_PROBES_PRE_RESET: Tuple[TunerProbe, ...] = (
    TunerProbe(TunerType.E4000, 0xC8, 0x02, 0x40),    # tuner_e4k.h:27-29
    TunerProbe(TunerType.FC0013, 0xC6, 0x00, 0xA3),   # tuner_fc0013.h:28-30
    TunerProbe(TunerType.R820T, 0x34, 0x00, 0x69),    # tuner_r82xx.h:28,32-33
    TunerProbe(TunerType.R828D, 0x74, 0x00, 0x69),    # tuner_r82xx.h:29,32-33
)
TUNER_PROBES_POST_RESET: Tuple[TunerProbe, ...] = (
    TunerProbe(TunerType.FC2580, 0xAC, 0x01, 0x56, mask=0x7F),  # fc2580.h:8-10
    TunerProbe(TunerType.FC0012, 0xC6, 0x00, 0xA1),   # tuner_fc0012.h:28-30
)

R82XX_IF_FREQ_HZ = 3_570_000      # tuner_r82xx.h:35
R828D_XTAL_FREQ_HZ = 16_000_000   # tuner_r82xx.h:30

# tuner_plan gain-table keys per TunerType
_GAIN_TABLE_KEY = {
    TunerType.E4000: "e4000", TunerType.FC0012: "fc0012",
    TunerType.FC0013: "fc0013", TunerType.FC2580: "fc2580",
    TunerType.R820T: "r820t", TunerType.R828D: "r828d",
}

TUNER_I2C_ADDR = {
    TunerType.E4000: 0xC8, TunerType.FC0012: 0xC6,
    TunerType.FC0013: 0xC6, TunerType.FC2580: 0xAC,
    TunerType.R820T: 0x34, TunerType.R828D: 0x74,
}


# --- known dongles (VID, PID) → product string ------------------------------
# The reference enumerates against a ~100-entry table
# (`librtlsdr.c:314-356`). VID/PID assignments are registry facts; we
# carry the entries the fleet has actually seen plus the generic ids,
# and treat any RTL2832U-class composite as probe-eligible.
KNOWN_DEVICES: Dict[Tuple[int, int], str] = {
    (0x0BDA, 0x2832): "Generic RTL2832U",
    (0x0BDA, 0x2838): "Generic RTL2832U OEM",
    (0x0413, 0x6680): "DigitalNow Quad DVB-T PCI-E card",
    (0x0413, 0x6F0F): "Leadtek WinFast DTV Dongle mini D",
    (0x0458, 0x707F): "Genius TVGo DVB-T03 USB dongle (Ver. B)",
    (0x0CCD, 0x00A9): "Terratec Cinergy T Stick Black (rev 1)",
    (0x0CCD, 0x00B3): "Terratec NOXON DAB/DAB+ USB dongle (rev 1)",
    (0x0CCD, 0x00D3): "Terratec Cinergy T Stick RC (Rev.3)",
    (0x0CCD, 0x00D7): "Terratec T Stick PLUS",
    (0x0CCD, 0x00E0): "Terratec NOXON DAB/DAB+ USB dongle (rev 2)",
    (0x1554, 0x5020): "PixelView PV-DT235U(RN)",
    (0x15F4, 0x0131): "Astrometa DVB-T/DVB-T2",
    (0x185B, 0x0620): "Compro Videomate U620F",
    (0x185B, 0x0650): "Compro Videomate U650F",
    (0x1B80, 0xD393): "GIGABYTE GT-U7300",
    (0x1B80, 0xD3A4): "Twintech UT-40",
    (0x1D19, 0x1101): "Dexatek DK DVB-T Dongle (Logilink VG0002A)",
    (0x1F4D, 0xB803): "GTek T803",
    (0x1F4D, 0xC803): "Lifeview LV5TDeluxe",
    (0x1F4D, 0xD286): "MyGica TD312",
    (0x1F4D, 0xD803): "PROlectrix DV107669",
}


def identify_device(vid: int, pid: int) -> Optional[str]:
    """Known-device lookup (`find_known_device`, `librtlsdr.c:1262-1276`)."""
    return KNOWN_DEVICES.get((vid, pid))


# --- transport interface ----------------------------------------------------


class UsbTransport(Protocol):
    """The physical boundary. ``control_transfer`` maps 1:1 onto
    ``libusb_control_transfer(devh, request_type, 0, wValue, wIndex,
    buf, len, 300)``; ``bulk_read`` onto a bulk IN on endpoint 0x81
    (`librtlsdr.c:1653-1659`)."""

    def control_transfer(self, xfer: ControlTransfer) -> bytes:
        """IN: return ``xfer.length`` bytes. OUT: apply ``xfer.data``,
        return b''. Raise ``TransportError`` on stall/failure."""
        ...

    def bulk_read(self, length: int) -> bytes: ...

    def reset(self) -> None:
        """``libusb_reset_device`` equivalent (`librtlsdr.c:1495`)."""
        ...


class TransportError(IOError):
    pass


# --- the driver -------------------------------------------------------------


class Rtl2832u:
    """Register-level RTL2832U driver over an abstract USB transport.

    State mirrors the reference's ``rtlsdr_dev_t`` working set
    (`librtlsdr.c:113-140`): crystals, current rate/freq/corr, tuner
    type, offset-tuning shift, direct-sampling mode.
    """

    def __init__(self, transport: UsbTransport, *,
                 rtl_xtal_hz: int = tuner_plan.DEFAULT_RTL_XTAL_HZ):
        self.t = transport
        self.rtl_xtal_hz = rtl_xtal_hz
        self.tun_xtal_hz = rtl_xtal_hz
        self.tuner_type = TunerType.UNKNOWN
        self.rate_hz = 0
        self.freq_hz = 0
        self.corr_ppm = 0
        self.offs_freq_hz = 0
        self.direct_sampling = 0
        self.fir = list(FIR_DEFAULT)

    # -- raw block access (`librtlsdr.c:409-434`) --

    def read_array(self, block: int, addr: int, length: int) -> bytes:
        return self.t.control_transfer(encode_read_array(block, addr, length))

    def write_array(self, block: int, addr: int, data: bytes) -> None:
        self.t.control_transfer(encode_write_array(block, addr, data))

    # -- 16-bit register access (`librtlsdr.c:476-520`) --

    def read_reg(self, block: int, addr: int, length: int = 1) -> int:
        return decode_reg_value(self.read_array(block, addr, length))

    def write_reg(self, block: int, addr: int, val: int,
                  length: int = 1) -> None:
        self.write_array(block, addr, encode_reg_value(val, length))

    # -- demod page registers (`librtlsdr.c:522-582`) --

    def demod_read_reg(self, page: int, addr: int, length: int = 1) -> int:
        xfer = ControlTransfer(CTRL_IN, ((addr << 8) | 0x20) & 0xFFFF,
                               page, length=length)
        return decode_reg_value(self.t.control_transfer(xfer))

    def demod_write_reg(self, page: int, addr: int, val: int,
                        length: int = 1) -> None:
        xfer = ControlTransfer(CTRL_OUT, ((addr << 8) | 0x20) & 0xFFFF,
                               0x10 | page,
                               data=encode_reg_value(val, length))
        self.t.control_transfer(xfer)
        # the reference always chases a demod write with a status read of
        # page 0x0a reg 0x01 (`librtlsdr.c:557`) — an I2C-bridge flush
        self.demod_read_reg(0x0A, 0x01, 1)

    # -- I2C bridge (`librtlsdr.c:435-474, 583`) --

    def i2c_write(self, i2c_addr: int, data: bytes) -> None:
        self.write_array(Block.IIC, i2c_addr, data)

    def i2c_read(self, i2c_addr: int, length: int) -> bytes:
        return self.read_array(Block.IIC, i2c_addr, length)

    def i2c_write_reg(self, i2c_addr: int, reg: int, val: int) -> None:
        self.i2c_write(i2c_addr, bytes([reg & 0xFF, val & 0xFF]))

    def i2c_read_reg(self, i2c_addr: int, reg: int) -> int:
        self.i2c_write(i2c_addr, bytes([reg & 0xFF]))
        return self.i2c_read(i2c_addr, 1)[0]

    def set_i2c_repeater(self, on: bool) -> None:
        self.demod_write_reg(1, 0x01, 0x18 if on else 0x10, 1)

    # -- GPIO (`librtlsdr.c:562-581`) --

    def set_gpio_bit(self, gpio: int, val: int) -> None:
        mask = 1 << gpio
        r = self.read_reg(Block.SYS, SysReg.GPO, 1)
        r = (r | mask) if val else (r & ~mask)
        self.write_reg(Block.SYS, SysReg.GPO, r, 1)

    def set_gpio_output(self, gpio: int) -> None:
        mask = 1 << gpio
        r = self.read_reg(Block.SYS, SysReg.GPD, 1)
        self.write_reg(Block.SYS, SysReg.GPO, r & ~mask, 1)
        r = self.read_reg(Block.SYS, SysReg.GPOE, 1)
        self.write_reg(Block.SYS, SysReg.GPOE, r | mask, 1)

    # -- FIR + baseband bring-up (`librtlsdr.c:584-676`) --

    def set_fir(self, coeffs: Optional[Sequence[int]] = None) -> None:
        if coeffs is not None:
            self.fir = list(coeffs)
        image = pack_fir(self.fir)
        for i, b in enumerate(image):
            self.demod_write_reg(1, 0x1C + i, b, 1)

    def init_baseband(self) -> None:
        """Power-on sequence (`rtlsdr_init_baseband`,
        `librtlsdr.c:616-676`). Order matters to the silicon; kept
        verbatim as a protocol constant."""
        # USB endpoint A: FIFO config, max packet, reset
        self.write_reg(Block.USB, UsbReg.SYSCTL, 0x09, 1)
        self.write_reg(Block.USB, UsbReg.EPA_MAXPKT, 0x0002, 2)
        self.write_reg(Block.USB, UsbReg.EPA_CTL, 0x1002, 2)
        # power on demod
        self.write_reg(Block.SYS, SysReg.DEMOD_CTL_1, 0x22, 1)
        self.write_reg(Block.SYS, SysReg.DEMOD_CTL, 0xE8, 1)
        # soft reset pulse
        self.demod_write_reg(1, 0x01, 0x14, 1)
        self.demod_write_reg(1, 0x01, 0x10, 1)
        # spectrum inversion / adjacent-channel rejection off
        self.demod_write_reg(1, 0x15, 0x00, 1)
        self.demod_write_reg(1, 0x16, 0x0000, 2)
        # clear DDC shift + IF registers
        for i in range(6):
            self.demod_write_reg(1, 0x16 + i, 0x00, 1)
        self.set_fir()
        # SDR mode on, DAGC off
        self.demod_write_reg(0, 0x19, 0x05, 1)
        # FSM state-holding registers
        self.demod_write_reg(1, 0x93, 0xF0, 1)
        self.demod_write_reg(1, 0x94, 0x0F, 1)
        # AGC loops off
        self.demod_write_reg(1, 0x11, 0x00, 1)
        self.demod_write_reg(1, 0x04, 0x00, 1)
        # PID filter off
        self.demod_write_reg(0, 0x61, 0x60, 1)
        # default ADC I/Q datapath
        self.demod_write_reg(0, 0x06, 0x80, 1)
        # zero-IF, DC cancel, IQ estimate/compensate
        self.demod_write_reg(1, 0xB1, 0x1B, 1)
        # 4.096 MHz clock output off
        self.demod_write_reg(0, 0x0D, 0x83, 1)

    def deinit_baseband(self) -> None:
        """Power-off (`librtlsdr.c:678-688`): demod + ADCs down."""
        self.write_reg(Block.SYS, SysReg.DEMOD_CTL, 0x20, 1)

    # -- IF / ppm / sample rate (`librtlsdr.c:690-727, 1075-1126`) --

    def _corrected_xtals(self) -> Tuple[int, int]:
        """ppm-corrected (rtl, tuner) crystals (`librtlsdr.c:769-784`)."""
        f = 1.0 + self.corr_ppm / 1e6
        return int(self.rtl_xtal_hz * f), int(self.tun_xtal_hz * f)

    def set_if_freq(self, freq_hz: int) -> None:
        """Digital down-converter IF (`rtlsdr_set_if_freq`,
        `librtlsdr.c:690-714`): 22-bit two's-complement ratio across
        demod page 1 regs 0x19-0x1b."""
        rtl_xtal, _ = self._corrected_xtals()
        if_reg = -int((int(freq_hz) * (1 << 22)) // rtl_xtal)
        self.demod_write_reg(1, 0x19, (if_reg >> 16) & 0x3F, 1)
        self.demod_write_reg(1, 0x1A, (if_reg >> 8) & 0xFF, 1)
        self.demod_write_reg(1, 0x1B, if_reg & 0xFF, 1)

    def set_sample_freq_correction(self, ppm: int) -> None:
        """Resampler ppm trim (`librtlsdr.c:716-727`): −ppm·2²⁴/1e6 into
        demod page 1 regs 0x3e/0x3f."""
        offs = int(-ppm * (1 << 24) / 1_000_000)
        self.demod_write_reg(1, 0x3F, offs & 0xFF, 1)
        self.demod_write_reg(1, 0x3E, (offs >> 8) & 0x3F, 1)

    def set_sample_rate(self, samp_rate_hz: int) -> float:
        """Program the rational resampler (`rtlsdr_set_sample_rate`,
        `librtlsdr.c:1075-1126`) from :func:`tuner_plan.plan_sample_rate`
        and return the achieved rate."""
        plan = tuner_plan.plan_sample_rate(samp_rate_hz,
                                           xtal_hz=self.rtl_xtal_hz)
        self.rate_hz = int(plan.real_rate_hz)
        self.demod_write_reg(1, 0x9F, (plan.rsamp_ratio >> 16) & 0xFFFF, 2)
        self.demod_write_reg(1, 0xA1, plan.rsamp_ratio & 0xFFFF, 2)
        self.set_sample_freq_correction(self.corr_ppm)
        # soft reset pulse
        self.demod_write_reg(1, 0x01, 0x14, 1)
        self.demod_write_reg(1, 0x01, 0x10, 1)
        if self.offs_freq_hz:
            self.set_offset_tuning(True)
        return plan.real_rate_hz

    def set_freq_correction(self, ppm: int) -> None:
        """`librtlsdr.c:926-948`: store, trim the resampler, retune."""
        if self.corr_ppm == ppm:
            return
        self.corr_ppm = ppm
        self.set_sample_freq_correction(ppm)
        if self.freq_hz:
            self.set_center_freq(self.freq_hz)

    # -- tuner-side tuning ---------------------------------------------------

    def _write_tuner_lo_plan(self, freq_hz: int) -> float:
        """Program the tuner LO and return the achieved frequency.

        The reference dispatches through a per-chip vtable into ~1000
        lines of chip driver each (`tuner_r82xx.c:1076`,
        `tuner_e4k.c:572`, ...). Here the quantization math — the part
        that affects TDOA solutions — comes from
        :mod:`~radio_mapper_tpu_torch.net.tuner_plan`, and the plan's register
        fields are shipped to the chip as an I2C write burst. The mock
        transport's tuner models decode the same fields, closing the
        loop in tests; real dongles in this fleet are driven through
        rtl_tcp hosts whose firmware stack owns the chip-specific burst
        layout (see module docstring + `net/rtl_tcp.py`).
        """
        _, tun_xtal = self._corrected_xtals()
        tt = self.tuner_type
        if tt in (TunerType.R820T, TunerType.R828D):
            plan = tuner_plan.plan_r82xx_pll(
                freq_hz + R82XX_IF_FREQ_HZ, xtal_hz=tun_xtal,
                vco_power_ref=1 if tt == TunerType.R828D else 2)
            achieved = plan.actual_hz - R82XX_IF_FREQ_HZ
        elif tt == TunerType.E4000:
            plan = tuner_plan.plan_e4k_pll(freq_hz, fosc_hz=tun_xtal)
            achieved = plan.actual_hz
        elif tt == TunerType.FC0012:
            plan = tuner_plan.plan_fc0012_pll(freq_hz, xtal_hz=tun_xtal)
            achieved = plan.actual_hz
        elif tt == TunerType.FC0013:
            plan = tuner_plan.plan_fc0013_pll(freq_hz, xtal_hz=tun_xtal)
            achieved = plan.actual_hz
        elif tt == TunerType.FC2580:
            plan = tuner_plan.plan_fc2580_pll(freq_hz, xtal_hz=tun_xtal)
            achieved = plan.actual_hz
        else:
            raise TransportError("no tuner to tune")
        addr = TUNER_I2C_ADDR[tt]
        burst = bytearray([0x00])  # plan-burst marker register
        for key in sorted(plan.params):
            v = int(plan.params[key]) & 0xFFFFFFFF
            burst += v.to_bytes(4, "little")
        self.i2c_write(addr, bytes(burst))
        return achieved

    def set_center_freq(self, freq_hz: int) -> float:
        """`rtlsdr_set_center_freq` (`librtlsdr.c:888-913`): direct
        sampling tunes the 2832's own IF; otherwise the tuner LO is set
        (offset-shifted) under the I2C repeater."""
        if self.direct_sampling:
            self.set_if_freq(freq_hz)
            achieved = tuner_plan.plan_if_freq(
                freq_hz, xtal_hz=self.rtl_xtal_hz, ppm=self.corr_ppm)
        else:
            self.set_i2c_repeater(True)
            try:
                achieved = self._write_tuner_lo_plan(
                    freq_hz - self.offs_freq_hz) + self.offs_freq_hz
            finally:
                self.set_i2c_repeater(False)
        self.freq_hz = int(freq_hz)
        return achieved

    # -- mode setters (`librtlsdr.c:1135-1258`) --

    def set_testmode(self, on: bool) -> None:
        """8-bit counter test pattern instead of ADC data
        (`librtlsdr.c:1135-1141`) — the drop-detection mode rtl_test and
        `tools/sdr_test.py` rely on."""
        self.demod_write_reg(0, 0x19, 0x03 if on else 0x05, 1)

    def set_agc_mode(self, on: bool) -> None:
        self.demod_write_reg(0, 0x19, 0x25 if on else 0x05, 1)

    def set_direct_sampling(self, mode: int) -> None:
        """0=off, 1=I-branch, 2=Q-branch (`librtlsdr.c:1151-1212`)."""
        if mode:
            self.demod_write_reg(1, 0xB1, 0x1A, 1)   # zero-IF off
            self.demod_write_reg(1, 0x15, 0x00, 1)   # inversion off
            self.demod_write_reg(0, 0x08, 0x4D, 1)   # I-ADC only
            self.demod_write_reg(0, 0x06, 0x90 if mode > 1 else 0x80, 1)
            self.direct_sampling = mode
        else:
            if self.tuner_type in (TunerType.R820T, TunerType.R828D):
                self.set_if_freq(R82XX_IF_FREQ_HZ)
                self.demod_write_reg(1, 0x15, 0x01, 1)
            else:
                self.set_if_freq(0)
                self.demod_write_reg(0, 0x08, 0xCD, 1)
                self.demod_write_reg(1, 0xB1, 0x1B, 1)
            self.demod_write_reg(0, 0x06, 0x80, 1)
            self.direct_sampling = 0
        if self.freq_hz:
            self.set_center_freq(self.freq_hz)

    def set_offset_tuning(self, on: bool) -> None:
        """Zero-IF DC-spur dodge for non-R82xx tuners
        (`librtlsdr.c:1227-1252`)."""
        if self.tuner_type in (TunerType.R820T, TunerType.R828D):
            raise TransportError("offset tuning unsupported on R82xx")
        if self.direct_sampling:
            raise TransportError("offset tuning in direct-sampling mode")
        self.offs_freq_hz = (tuner_plan.offset_tuning_offs_hz(self.rate_hz)
                             if on else 0)
        self.set_if_freq(self.offs_freq_hz)
        if self.freq_hz > self.offs_freq_hz:
            self.set_center_freq(self.freq_hz)

    # -- gains ---------------------------------------------------------------

    def get_tuner_gains(self) -> Tuple[int, ...]:
        key = _GAIN_TABLE_KEY.get(self.tuner_type)
        if key is None:
            return ()
        return tuner_plan.TUNER_GAINS[key]

    def set_tuner_gain(self, tenth_db: int) -> int:
        """Snap to the tuner table and ship as an I2C gain write
        (`rtlsdr_set_tuner_gain`, `librtlsdr.c:1012-1032`)."""
        key = _GAIN_TABLE_KEY.get(self.tuner_type)
        if key is None:
            raise TransportError("no tuner")
        snapped = tuner_plan.nearest_gain(tenth_db, key)
        self.set_i2c_repeater(True)
        try:
            # gain-burst marker register 0x01; value in tenth-dB, int16
            self.i2c_write(TUNER_I2C_ADDR[self.tuner_type],
                           bytes([0x01]) + int(snapped).to_bytes(
                               2, "little", signed=True))
        finally:
            self.set_i2c_repeater(False)
        return snapped

    # -- EEPROM (`librtlsdr.c:825-886`) --

    def read_eeprom(self, offset: int, length: int) -> bytes:
        if offset + length > EEPROM_SIZE:
            raise ValueError("EEPROM read out of range")
        # set the address pointer, then byte-at-a-time sequential reads
        self.write_array(Block.IIC, EEPROM_I2C_ADDR, bytes([offset]))
        out = bytearray()
        for _ in range(length):
            out += self.read_array(Block.IIC, EEPROM_I2C_ADDR, 1)
        return bytes(out)

    def write_eeprom(self, data: bytes, offset: int = 0) -> int:
        """Differs-only programming (`rtlsdr_write_eeprom`,
        `librtlsdr.c:825-863`): each byte is read back first and written
        only on mismatch (EEPROM wear + the reference's ATC 240LC02
        write-delay workaround). Returns bytes actually written."""
        if offset + len(data) > EEPROM_SIZE:
            raise ValueError("EEPROM write out of range")
        written = 0
        for i, b in enumerate(data):
            addr = offset + i
            self.write_array(Block.IIC, EEPROM_I2C_ADDR, bytes([addr]))
            cur = self.read_array(Block.IIC, EEPROM_I2C_ADDR, 1)[0]
            if cur == b:
                continue
            self.write_array(Block.IIC, EEPROM_I2C_ADDR, bytes([addr, b]))
            written += 1
        return written

    # -- open / probe (`librtlsdr.c:1407-1602`) --

    def probe_tuner(self) -> TunerType:
        """I2C tuner identification in the reference's exact order,
        including the GPIO5 reset pulse before the FC2580/FC0012
        probes (`librtlsdr.c:1501-1552`). Assumes the I2C repeater is
        already on (as in `rtlsdr_open`)."""

        def check(p: TunerProbe) -> bool:
            try:
                reg = self.i2c_read_reg(p.i2c_addr, p.check_reg)
            except TransportError:
                return False
            return (reg & p.mask) == p.check_val

        for p in TUNER_PROBES_PRE_RESET:
            if check(p):
                return p.tuner
        # reset tuner via GPIO5 before the remaining probes
        self.set_gpio_output(5)
        self.set_gpio_bit(5, 1)
        self.set_gpio_bit(5, 0)
        for p in TUNER_PROBES_POST_RESET:
            if check(p):
                if p.tuner == TunerType.FC0012:
                    self.set_gpio_output(6)
                return p.tuner
        return TunerType.UNKNOWN

    def open(self) -> TunerType:
        """Bring-up state machine (`rtlsdr_open`,
        `librtlsdr.c:1407-1602`): dummy-write probe (reset on failure) →
        baseband init → tuner probe under the I2C repeater → per-tuner
        demod configuration."""
        try:
            self.write_reg(Block.USB, UsbReg.SYSCTL, 0x09, 1)
        except TransportError:
            log.warning("dummy write failed — resetting device")
            self.t.reset()
        self.init_baseband()
        self.set_i2c_repeater(True)
        try:
            self.tuner_type = self.probe_tuner()
            if self.tuner_type in (TunerType.R820T, TunerType.R828D):
                if self.tuner_type == TunerType.R828D:
                    self.tun_xtal_hz = R828D_XTAL_FREQ_HZ
                # R82xx runs low-IF, not zero-IF: I-ADC only, 3.57 MHz
                # IF, spectrum inversion on (`librtlsdr.c:1559-1575`)
                self.demod_write_reg(1, 0xB1, 0x1A, 1)
                self.demod_write_reg(0, 0x08, 0x4D, 1)
                self.set_if_freq(R82XX_IF_FREQ_HZ)
                self.demod_write_reg(1, 0x15, 0x01, 1)
            elif self.tuner_type == TunerType.UNKNOWN:
                log.warning("no supported tuner found — direct sampling")
                self.set_direct_sampling(1)
        finally:
            self.set_i2c_repeater(False)
        return self.tuner_type

    def close(self) -> None:
        self.deinit_baseband()

    # -- streaming (`librtlsdr.c:1643-1659`) --

    def read_sync(self, num_bytes: int) -> bytes:
        """Single bulk IN — the reference's `rtlsdr_read_sync`. The
        async 15×256 KiB engine equivalent lives in `native/ingest.cpp`
        (`librtlsdr.c:1769-1891` parity is documented there)."""
        return self.t.bulk_read(num_bytes)


# --- bus enumeration + device search ----------------------------------------


@dataclasses.dataclass(frozen=True)
class UsbDeviceInfo:
    """USB descriptor facts enumeration filters/searches on — the
    subset of `libusb_device_descriptor` + string descriptors the
    reference reads (`librtlsdr.c:786-824, 1276-1299`)."""

    vid: int
    pid: int
    manufacturer: str = ""
    product: str = ""
    serial: str = ""


class UsbBus(Protocol):
    """A host USB bus: the raw device list (dongles AND everything
    else) plus the ability to open a slot — the `libusb_get_device_list`
    / `libusb_open` pair."""

    def devices(self) -> Sequence[UsbDeviceInfo]: ...

    def open(self, bus_slot: int) -> UsbTransport:
        """Open the device at raw bus slot `bus_slot` (NOT the dongle
        index — enumeration maps between the two)."""
        ...


def _enumerate_dongles(bus: UsbBus) -> List[Tuple[int, UsbDeviceInfo]]:
    """ONE bus snapshot → [(raw bus slot, descriptor)] for the known
    dongles, in bus order — dongle index i is the i-th entry
    (`librtlsdr.c:1288-1291`). All the API functions below take exactly
    one snapshot per call: `devices()` maps onto
    `libusb_get_device_list`, and two snapshots within one operation
    would race hot-(un)plug on a real bus."""
    return [(slot, d) for slot, d in enumerate(bus.devices())
            if identify_device(d.vid, d.pid) is not None]


def get_device_count(bus: UsbBus) -> int:
    """`rtlsdr_get_device_count` (`librtlsdr.c:1275-1300`)."""
    return len(_enumerate_dongles(bus))


def get_device_name(bus: UsbBus, index: int) -> str:
    """`rtlsdr_get_device_name` (`librtlsdr.c:1302-1336`): the KNOWN-
    DEVICES table name, '' when the index is out of range."""
    dongles = _enumerate_dongles(bus)
    if not 0 <= index < len(dongles):
        return ""
    _, d = dongles[index]
    return identify_device(d.vid, d.pid) or ""


def get_device_usb_strings(bus: UsbBus, index: int) -> Tuple[str, str, str]:
    """`rtlsdr_get_device_usb_strings` (`librtlsdr.c:1339-1379`):
    (manufacturer, product, serial) for dongle `index`."""
    dongles = _enumerate_dongles(bus)
    if not 0 <= index < len(dongles):
        raise TransportError(f"no dongle at index {index}")
    _, d = dongles[index]
    return d.manufacturer, d.product, d.serial


def get_index_by_serial(bus: UsbBus, serial: str) -> int:
    """`rtlsdr_get_index_by_serial` (`librtlsdr.c:1382-1404`): exact
    serial match; negative error codes preserved (-2 no devices,
    -3 not found)."""
    dongles = _enumerate_dongles(bus)
    if not dongles:
        return -2
    for i, (_, d) in enumerate(dongles):
        if d.serial == serial:
            return i
    return -3


def device_search(bus: UsbBus, spec: str) -> int:
    """`verbose_device_search` (`Code/src/convenience/convenience.c:
    244-303`): resolve a user spec to a dongle index by, in order,
    raw index number → exact serial → serial prefix → serial suffix.
    Returns -1 when nothing matches (the reference's error code).

    DELIBERATE deviation from the C numeric parse: strtol base-0 reads
    leading-zero specs as octal, so the reference resolves the most
    common factory serial "00000001" to raw index 1 instead of the
    dongle carrying that serial, and accepts leading whitespace. Here a
    spec is an index only if it is a plain decimal/0x literal with no
    surrounding whitespace; zero-padded strings fall through to the
    serial matchers, which is what the user meant.
    """
    import re as _re

    dongles = _enumerate_dongles(bus)
    if not dongles:
        return -1
    serials = [d.serial for _, d in dongles]
    # exactly a plain decimal (no leading zeros) or 0x hex literal —
    # int(spec, 0) alone would also take 0b/0o/underscored forms, which
    # should fall through to the serial matchers like any other string
    if _re.fullmatch(r"(0|[1-9][0-9]*|0[xX][0-9a-fA-F]+)", spec):
        index = int(spec, 0)
        if 0 <= index < len(dongles):
            return index
    for i, sn in enumerate(serials):
        if sn == spec:
            return i
    for i, sn in enumerate(serials):
        if sn.startswith(spec):
            return i
    for i, sn in enumerate(serials):
        if sn.endswith(spec):
            return i
    return -1


def open_device(bus: UsbBus, index: int = 0, **dev_kwargs) -> Rtl2832u:
    """`rtlsdr_open` front half (`librtlsdr.c:1431-1449`): map dongle
    index → bus slot, open the transport, and run the bring-up state
    machine. Returns the ready driver."""
    dongles = _enumerate_dongles(bus)
    if not 0 <= index < len(dongles):
        raise TransportError(f"no dongle at index {index} "
                             f"({len(dongles)} present)")
    dev = Rtl2832u(bus.open(dongles[index][0]), **dev_kwargs)
    dev.open()
    return dev
