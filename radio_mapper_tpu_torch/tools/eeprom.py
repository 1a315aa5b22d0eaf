"""RTL2832U EEPROM image codec — `rtl_eeprom` capability parity.

The reference ships an EEPROM programming tool (`Code/src/rtl_eeprom.c`)
that reads/parses/edits/writes the dongle's 256-byte configuration
EEPROM. The image *format* is hardware-independent; this module provides
the full codec (parse, dump, edit, generate, factory presets) operating
on `.bin` image files. Physically flashing a dongle remains a
dongle-host task (osmocom `rtl_eeprom -w`), consistent with this
framework's delegation of USB access to the rtl_tcp host (docs/PARITY.md).

Format (per `Code/src/rtl_eeprom.c`):
  - 256-byte image (`rtl_eeprom.c:33`), header bytes 0x28 0x32
    (`rtl_eeprom.c:136, 156-157`)
  - vendor/product id little-endian at bytes 2-5 (`rtl_eeprom.c:139-140`)
  - byte 6 == 0xa5 marks "serial present" (`rtl_eeprom.c:141`)
  - byte 7: base 0x14, bit0 remote-wakeup, bit1 IR endpoint enabled
    (`rtl_eeprom.c:142-143, 163-165`)
  - byte 8 = 0x02 (`rtl_eeprom.c:166`)
  - three USB string descriptors (len, 0x03, UTF-16LE chars) packed from
    offset 0x09, hard-bounded at byte 78 (`rtl_eeprom.c:60-131`)
  - byte 78 doubles as the IR-config length, zeroed (`rtl_eeprom.c:172`)

Port of ``radio_mapper_tpu/tools/eeprom.py``: a copy; images are
byte-equal between the packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

EEPROM_SIZE = 256
STR_OFFSET = 0x09
STR_LIMIT = 78  # strings must fit below this byte (rtl_eeprom.c:117)
HEADER = bytes((0x28, 0x32))


class EepromError(ValueError):
    pass


@dataclasses.dataclass
class EepromConfig:
    """Mirror of the reference's `rtlsdr_config_t` (`rtl_eeprom.c:39-48`)."""

    vendor_id: int = 0x0BDA
    product_id: int = 0x2832
    manufacturer: str = "Generic"
    product: str = "RTL2832U DVB-T"
    serial: str = "0"
    have_serial: bool = True
    enable_ir: bool = False
    remote_wakeup: bool = True


# Factory presets (`rtl_eeprom.c:186-247`, usage text :85-90).
DEFAULT_CONFIGS: Dict[str, EepromConfig] = {
    "realtek": EepromConfig(0x0BDA, 0x2832, "Generic", "RTL2832U DVB-T", "0",
                            True, False, True),
    "realtek_oem": EepromConfig(0x0BDA, 0x2838, "Realtek", "RTL2838UHIDIR",
                                "00000001", True, True, False),
    "noxon": EepromConfig(0x0CCD, 0x00B3, "NOXON", "DAB Stick", "0",
                          True, False, True),
    "terratec_black": EepromConfig(0x0CCD, 0x00A9, "Realtek", "RTL2838UHIDIR",
                                   "00000001", True, True, False),
    "terratec_plus": EepromConfig(0x0CCD, 0x00D7, "Realtek", "RTL2838UHIDIR",
                                  "00000001", True, True, False),
}


def _read_string_descriptor(data: bytes, pos: int) -> tuple[str, int]:
    """USB string descriptor: [len, 0x03, c0, 0x00, c1, 0x00, ...]
    (`rtl_eeprom.c:60-74`)."""
    length = data[pos]
    if pos + 1 >= len(data) or data[pos + 1] != 0x03:
        raise EepromError(f"invalid string descriptor at byte {pos}")
    chars = bytes(data[pos + i] for i in range(2, length, 2))
    # Advance exactly as the reference's loop does: to the first even
    # index >= length (minimum 2).
    adv = 2 if length < 2 else (length if length % 2 == 0 else length + 1)
    return chars.decode("latin-1"), pos + adv


def _write_string_descriptor(buf: bytearray, pos: int, text: str) -> int:
    """Pack a string descriptor; reject overflow past byte STR_LIMIT
    (`rtl_eeprom.c:76-99` — the reference truncates with a warning; we
    fail loudly instead so images are never silently corrupted)."""
    j = 2
    for ch in text:
        if pos + j + 1 >= STR_LIMIT:
            raise EepromError(
                "strings too long: descriptors must fit below byte "
                f"{STR_LIMIT} (overflow while writing {text!r})"
            )
        buf[pos + j] = ord(ch) & 0xFF
        buf[pos + j + 1] = 0x00
        j += 2
    buf[pos] = j
    buf[pos + 1] = 0x03
    return pos + j


def parse_image(data: bytes) -> EepromConfig:
    """Decode a 256-byte EEPROM image (`parse_eeprom_to_conf`,
    `rtl_eeprom.c:132-150`)."""
    if len(data) < STR_LIMIT:
        raise EepromError(f"image too short: {len(data)} bytes")
    if bytes(data[:2]) != HEADER:
        raise EepromError(
            f"bad header {data[0]:#04x} {data[1]:#04x} (expected 0x28 0x32)"
        )
    conf = EepromConfig(
        vendor_id=data[2] | (data[3] << 8),
        product_id=data[4] | (data[5] << 8),
        have_serial=data[6] == 0xA5,
        remote_wakeup=bool(data[7] & 0x01),
        enable_ir=bool(data[7] & 0x02),
    )
    pos = STR_OFFSET
    conf.manufacturer, pos = _read_string_descriptor(data, pos)
    conf.product, pos = _read_string_descriptor(data, pos)
    conf.serial, _ = _read_string_descriptor(data, pos)
    return conf


def generate_image(conf: EepromConfig) -> bytes:
    """Encode a config into a full 256-byte image (`gen_eeprom_from_conf`,
    `rtl_eeprom.c:152-174`)."""
    buf = bytearray(EEPROM_SIZE)
    buf[0:2] = HEADER
    buf[2] = conf.vendor_id & 0xFF
    buf[3] = (conf.vendor_id >> 8) & 0xFF
    buf[4] = conf.product_id & 0xFF
    buf[5] = (conf.product_id >> 8) & 0xFF
    buf[6] = 0xA5 if conf.have_serial else 0x00
    buf[7] = 0x14 | (0x01 if conf.remote_wakeup else 0) | (
        0x02 if conf.enable_ir else 0)
    buf[8] = 0x02
    pos = _write_string_descriptor(buf, STR_OFFSET, conf.manufacturer)
    pos = _write_string_descriptor(buf, pos, conf.product)
    _write_string_descriptor(buf, pos, conf.serial)
    buf[STR_LIMIT] = 0x00  # IR config length (rtl_eeprom.c:172)
    return bytes(buf)


def format_config(conf: EepromConfig) -> str:
    """Human-readable dump (`dump_config`, `rtl_eeprom.c:50-66`)."""
    return "\n".join([
        "__________________________________________",
        f"Vendor ID:\t\t0x{conf.vendor_id:04x}",
        f"Product ID:\t\t0x{conf.product_id:04x}",
        f"Manufacturer:\t\t{conf.manufacturer}",
        f"Product:\t\t{conf.product}",
        f"Serial number:\t\t{conf.serial}",
        f"Serial number enabled:\t{'yes' if conf.have_serial else 'no'}",
        f"IR endpoint enabled:\t{'yes' if conf.enable_ir else 'no'}",
        f"Remote wakeup enabled:\t{'yes' if conf.remote_wakeup else 'no'}",
        "__________________________________________",
    ])


def add_args(ap) -> None:
    """Register the eeprom tool's flags on an argparse parser."""
    ap.add_argument("--read", metavar="FILE", help="parse and dump an image")
    ap.add_argument("--out", metavar="FILE", help="write the (edited) image")
    ap.add_argument("--generate", choices=sorted(DEFAULT_CONFIGS),
                    help="start from a factory preset")
    ap.add_argument("--manufacturer", help="set manufacturer string")
    ap.add_argument("--product", help="set product string")
    ap.add_argument("--serial", help="set serial string")
    ap.add_argument("--ir", type=int, choices=(0, 1),
                    help="disable/enable IR endpoint")
    ap.add_argument("--wakeup", type=int, choices=(0, 1),
                    help="disable/enable remote wakeup")


def run(args, error=None) -> int:
    """Execute with a parsed namespace; `error` reports usage errors."""
    if args.read:
        with open(args.read, "rb") as f:
            conf = parse_image(f.read())
    elif args.generate:
        conf = dataclasses.replace(DEFAULT_CONFIGS[args.generate])
    else:
        msg = "need --read FILE or --generate PRESET"
        if error is not None:
            error(msg)
        raise SystemExit(f"error: {msg}")

    if args.manufacturer is not None:
        conf.manufacturer = args.manufacturer
    if args.product is not None:
        conf.product = args.product
    if args.serial is not None:
        conf.serial = args.serial
        conf.have_serial = True
    if args.ir is not None:
        conf.enable_ir = bool(args.ir)
    if args.wakeup is not None:
        conf.remote_wakeup = bool(args.wakeup)

    print(format_config(conf))
    if args.out:
        with open(args.out, "wb") as f:
            f.write(generate_image(conf))
        print(f"wrote {EEPROM_SIZE}-byte image to {args.out}")
    return 0


def main(argv=None) -> int:
    """Standalone CLI: read/dump/edit/generate EEPROM image files."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="radio_mapper_tpu_torch eeprom",
        description="RTL2832 EEPROM image tool (file-based rtl_eeprom parity)",
    )
    add_args(ap)
    args = ap.parse_args(argv)
    return run(args, error=ap.error)


if __name__ == "__main__":
    raise SystemExit(main())
