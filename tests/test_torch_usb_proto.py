"""The port's RTL2832U USB driver and register-level dongle model
(``radio_mapper_tpu_torch.net.usb_proto``, ``.net.rtl2832u_model``) against
the JAX package's (``radio_mapper_tpu.net``).

For every tuner type (and a dongle with none) the same script of driver
calls runs four ways: the port's driver on the port's model, the
reference's driver on the reference's model, and both cross-wired (the
port's driver on the reference's model and the reverse, each behind an
adapter that raises the driver's own ``TransportError``). Every way must
give the same returns (or the same exception class and message), the same
driver state, the same register files (block registers, demod pages, every
I2C chip's registers, the tuner's decoded LO plans and gain writes), the
same transfer counts and the same ``write_log``, transfer for transfer.
Enumeration and device search run over equal ``MockUsbBus``es; the
stall/reset recovery runs both ways.

Tolerance: exact. All of it is host integer arithmetic and bytes.
"""

import dataclasses

import numpy as np
import pytest

from radio_mapper_tpu.net import rtl2832u_model as jmodel
from radio_mapper_tpu.net import usb_proto as jup
from radio_mapper_tpu.tools import eeprom as jee

from radio_mapper_tpu_torch.net import rtl2832u_model as model
from radio_mapper_tpu_torch.net import usb_proto as up
from radio_mapper_tpu_torch.tools import eeprom as ee
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

TUNERS = ["E4000", "FC0012", "FC0013", "FC2580", "R820T", "R828D", None]
WAYS = {  # (driver module, model module)
    "port": (up, model),
    "ref": (jup, jmodel),
    "port_on_ref": (up, jmodel),
    "ref_on_port": (jup, model),
}


def _call(fn, *a, **kw):
    """A call's result, or its exception's class name and message."""
    try:
        out = fn(*a, **kw)
    except Exception as e:  # compared across ways, class and message
        return ("raised", type(e).__name__, str(e))
    if isinstance(out, (up.TunerType, jup.TunerType)):
        return ("tuner", out.name)
    return out


class _Adapter:
    """A transport of one package behind the other package's driver: the
    driver's contract is that its transport raises the driver module's
    ``TransportError`` (what a libusb adapter would do), so the adapter
    maps the model's own ``TransportError`` onto it."""

    def __init__(self, t, drv):
        self.t, self.drv = t, drv

    def _wrap(self, fn, *a):
        try:
            return fn(*a)
        except (up.TransportError, jup.TransportError) as e:
            raise self.drv.TransportError(str(e)) from e

    def control_transfer(self, xfer):
        return self._wrap(self.t.control_transfer, xfer)

    def bulk_read(self, length):
        return self._wrap(self.t.bulk_read, length)

    def reset(self):
        return self._wrap(self.t.reset)


def _transport(drv, t):
    same = (drv is up) == isinstance(t, model.MockRtlUsbTransport)
    return t if same else _Adapter(t, drv)


def _drive(drv, mdl, tuner, eeprom_image=b"", fail_first_write=False):
    """The script: open → probe → rates → ppm → tune → gains → modes →
    counter test → idle read → EEPROM read/write → close. Returns the
    call results and the model's and driver's state."""
    tt = None if tuner is None else mdl.TunerType[tuner]
    t = mdl.MockRtlUsbTransport(tt, eeprom_image=eeprom_image, fail_first_write=fail_first_write)
    dev = drv.Rtl2832u(_transport(drv, t))
    res = [_call(dev.open)]
    for rate in (2_048_000, 1_000_000, 2_400_000, 500_000, 250_000):
        res.append(_call(dev.set_sample_rate, rate))
    res.append(_call(dev.set_freq_correction, 25))
    for f in (100_000_000, 121_500_000, 433_920_000, 868_000_000, 1_090_000_000):
        res.append(_call(dev.set_center_freq, f))
    for g in (-30, 0, 150, 280, 400, 900):
        res.append(_call(dev.set_tuner_gain, g))
    res.append(_call(dev.get_tuner_gains))
    res.append(_call(dev.set_agc_mode, True))
    res.append(_call(dev.set_agc_mode, False))
    res.append(_call(dev.set_offset_tuning, True))
    res.append(_call(dev.set_offset_tuning, False))
    for mode in (2, 1, 0):
        res.append(_call(dev.set_direct_sampling, mode))
    res.append(_call(dev.set_center_freq, 144_000_000))
    res.append(_call(dev.set_testmode, True))
    res.append(_call(dev.read_sync, 3000))
    res.append(_call(dev.read_sync, 1000))
    res.append(_call(dev.set_testmode, False))
    res.append(_call(dev.read_sync, 64))
    res.append(_call(dev.read_eeprom, 0, 32))
    res.append(_call(dev.write_eeprom, bytes(range(40, 56)), 100))
    res.append(_call(dev.read_eeprom, 96, 24))
    res.append(_call(dev.read_eeprom, 250, 10))
    res.append(_call(dev.close))
    state = {k: v for k, v in vars(dev).items() if k != "t"}
    state["tuner_type"] = state["tuner_type"].name
    return res, state, _model_state(t)


def _model_state(t):
    chips = {addr: (bytes(c.regs), c.pointer, getattr(c, "lo_plans", None), getattr(c, "gain_writes", None))
             for addr, c in t.i2c.items()}
    log = [(x.request_type, x.value, x.index, x.data, x.length) for x in t.write_log]
    return dict(block=dict(t.block_regs), demod=dict(t.demod_regs), chips=chips, log=log,
                stats=dataclasses.astuple(t.stats), resets=t.resets)


def test_constants_and_tables_equal():
    for name in ("CTRL_IN", "CTRL_OUT", "CTRL_TIMEOUT_MS", "BULK_ENDPOINT", "FIR_DEFAULT",
                 "R82XX_IF_FREQ_HZ", "R828D_XTAL_FREQ_HZ", "EEPROM_I2C_ADDR", "EEPROM_SIZE"):
        assert getattr(up, name) == getattr(jup, name), name
    for enum_name in ("Block", "UsbReg", "SysReg", "TunerType"):
        assert {e.name: int(e) for e in getattr(up, enum_name)} == {e.name: int(e) for e in getattr(jup, enum_name)}
    assert {k.name: v for k, v in up.TUNER_I2C_ADDR.items()} == {k.name: v for k, v in jup.TUNER_I2C_ADDR.items()}
    for probes in ("TUNER_PROBES_PRE_RESET", "TUNER_PROBES_POST_RESET"):
        ours = [(p.tuner.name, p.i2c_addr, p.check_reg, p.check_val, p.mask) for p in getattr(up, probes)]
        ref = [(p.tuner.name, p.i2c_addr, p.check_reg, p.check_val, p.mask) for p in getattr(jup, probes)]
        assert ours == ref


def test_encoders_equal():
    rng = np.random.default_rng(5)
    for _ in range(64):
        block, addr, n = int(rng.integers(0, 7)), int(rng.integers(0, 1 << 16)), int(rng.integers(1, 5))
        data = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert dataclasses.astuple(up.encode_read_array(block, addr, n)) == dataclasses.astuple(
            jup.encode_read_array(block, addr, n))
        assert dataclasses.astuple(up.encode_write_array(block, addr, data)) == dataclasses.astuple(
            jup.encode_write_array(block, addr, data))
        v = int(rng.integers(0, 1 << 16))
        assert up.encode_reg_value(v, n % 2 + 1) == jup.encode_reg_value(v, n % 2 + 1)
        assert up.decode_reg_value(data) == jup.decode_reg_value(data)
    for _ in range(32):
        coeffs = [int(c) for c in rng.integers(-128, 128, 8)] + [int(c) for c in rng.integers(-2048, 2048, 8)]
        assert _call(up.pack_fir, coeffs) == _call(jup.pack_fir, coeffs)
    assert _call(up.pack_fir, [0] * 15) == _call(jup.pack_fir, [0] * 15)
    assert _call(up.pack_fir, [200] + [0] * 15) == _call(jup.pack_fir, [200] + [0] * 15)
    for vid, pid in ((0x0BDA, 0x2832), (0x0BDA, 0x2838), (0x0CCD, 0x00B3), (0x1234, 0x5678)):
        assert up.identify_device(vid, pid) == jup.identify_device(vid, pid)


@pytest.mark.parametrize("tuner", TUNERS)
def test_driver_on_model_four_ways(tuner):
    image = jee.generate_image(jee.DEFAULT_CONFIGS["realtek_oem"])
    runs = {way: _drive(drv, mdl, tuner, eeprom_image=image) for way, (drv, mdl) in WAYS.items()}
    res, state, regs = runs["ref"]
    assert res[0] == ("tuner", tuner or "UNKNOWN")
    assert len(regs["log"]) > 50
    for way in ("port", "port_on_ref", "ref_on_port"):
        assert runs[way][0] == res, way
        assert runs[way][1] == state, way
        assert runs[way][2] == regs, way


@pytest.mark.parametrize("way", list(WAYS))
def test_stall_then_reset_recovery(way):
    drv, mdl = WAYS[way]
    ours = _drive(drv, mdl, "R820T", fail_first_write=True)
    ref = _drive(jup, jmodel, "R820T", fail_first_write=True)
    assert ours == ref
    assert ours[2]["resets"] == 1 and ours[0][0] == ("tuner", "R820T")


def test_repeater_off_tuner_traffic_fails_alike():
    msgs = []
    for drv, mdl in WAYS.values():
        dev = drv.Rtl2832u(_transport(drv, mdl.MockRtlUsbTransport(mdl.TunerType.R820T)))
        msgs.append(_call(dev.i2c_read_reg, 0x34, 0x00))
    assert msgs[0][0] == "raised" and all(m == msgs[0] for m in msgs)


def test_open_model_device():
    for tuner in TUNERS[:-1]:
        ours = model.open_model_device(model.TunerType[tuner])
        ref = jmodel.open_model_device(jmodel.TunerType[tuner])
        assert ours.tuner_type.name == ref.tuner_type.name == tuner
        assert _model_state(ours.t) == _model_state(ref.t)


def _bus(mdl, eemod, serials=("00000101", "buoy-07")):
    bus = mdl.MockUsbBus()
    bus.add_other_device(0x1D6B, 0x0002, "xHCI root hub")
    bus.add_dongle(mdl.TunerType.R820T, eemod.generate_image(
        eemod.EepromConfig(0x0BDA, 0x2838, "Realtek", "RTL2838UHIDIR", serials[0], True, False, True)))
    bus.add_other_device(0x046D, 0xC31C, "keyboard")
    bus.add_dongle(mdl.TunerType.E4000, eemod.generate_image(
        eemod.EepromConfig(0x0BDA, 0x2832, "Generic", "RTL2832U DVB-T", serials[1], True, False, True)))
    return bus


@pytest.mark.parametrize("serials", [("00000101", "buoy-07"), ("00000001", "00000002")])
def test_enumeration_and_search(serials):
    ours, ref = _bus(model, ee, serials), _bus(jmodel, jee, serials)
    assert [dataclasses.astuple(d) for d in ours.devices()] == [dataclasses.astuple(d) for d in ref.devices()]
    assert up.get_device_count(ours) == jup.get_device_count(ref) == 2
    for i in range(-1, 4):
        assert _call(up.get_device_name, ours, i) == _call(jup.get_device_name, ref, i)
        assert _call(up.get_device_usb_strings, ours, i) == _call(jup.get_device_usb_strings, ref, i)
    for spec in ("0", "1", "2", "0x1", " 1", "0b1", "0_1", "00000101", "buoy", "-07", "absent",
                 "00000001", "00000002", "0000", ""):
        assert up.device_search(ours, spec) == jup.device_search(ref, spec), spec
        assert up.get_index_by_serial(ours, spec) == jup.get_index_by_serial(ref, spec), spec
    assert up.get_index_by_serial(model.MockUsbBus(), "x") == jup.get_index_by_serial(jmodel.MockUsbBus(), "x")
    for slot in (-3, -1, 0, 1, 2, 3, 99):
        assert _call(lambda b, s: type(b.open(s)).__name__, ours, slot) == _call(
            lambda b, s: type(b.open(s)).__name__, ref, slot)
    for index in range(3):
        a, b = _call(up.open_device, ours, index), _call(jup.open_device, ref, index)
        if isinstance(b, tuple):
            assert a == b
        else:
            assert a.tuner_type.name == b.tuner_type.name
            assert _model_state(a.t) == _model_state(b.t)
