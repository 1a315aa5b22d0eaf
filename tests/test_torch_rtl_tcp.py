"""The port's rtl_tcp client, source and server (``radio_mapper_tpu_torch.net.rtl_tcp``)
against the JAX package's (``radio_mapper_tpu.net.rtl_tcp``), and
``Rtl2832uSource`` (the in-process USB driver on the dongle model) served
by both.

Every server binds port 0 and the test reads back the port it got: the
port's ``RtlTcpServer.port`` after ``start()``, the reference server's
listening socket otherwise. Servers run unthrottled; every client has a
socket timeout and is closed in a ``finally``.

Tolerance: exact. The wire is bytes: the header and command packing, the
stream bytes of the two servers on the same scenario and seed, the bytes
each client reads from the other package's server, the server ``state``
after the same command sequence, and the counter ramp of the modeled
dongle through either server.
"""

import socket
import struct
import time

import numpy as np
import pytest

from radio_mapper_tpu import sim as jsim
from radio_mapper_tpu.ingest import SimulatedSource as JSimulatedSource
from radio_mapper_tpu.ingest.sources import Rtl2832uSource as JRtl2832uSource
from radio_mapper_tpu.net import rtl2832u_model as jmodel
from radio_mapper_tpu.net import rtl_tcp as jrt

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.ingest import Rtl2832uSource, SimulatedSource
from radio_mapper_tpu_torch.net import rtl2832u_model as model
from radio_mapper_tpu_torch.net import rtl_tcp as rt
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

PKGS = {"port": (rt, sim, SimulatedSource), "ref": (jrt, jsim, JSimulatedSource)}
STATE_WAIT_S = 20.0  # a bound on the wait for the command handler, not a budget


def _serve(mod, source, **kw):
    """Start ``mod``'s server on port 0 in its thread; return it and the
    port it bound."""
    server = mod.RtlTcpServer(source, host="127.0.0.1", port=0, throttle=False, **kw)
    mod.serve_in_thread(server)
    port = server._server.sockets[0].getsockname()[1]
    if mod is rt:
        assert server.port == port != 0
    return server, port


def _sim_source(pkg, signal="tone", seed=3):
    _, simmod, cls = PKGS[pkg]
    return cls(simmod.default_scenario(signal=signal, seed=seed), 0)


def test_packing_and_constants():
    for name in ("MAGIC", "CMD_SET_FREQ", "CMD_SET_SAMPLE_RATE", "CMD_SET_GAIN_MODE", "CMD_SET_GAIN",
                 "CMD_SET_FREQ_CORRECTION", "CMD_SET_IF_GAIN", "CMD_SET_TEST_MODE", "CMD_SET_AGC_MODE",
                 "CMD_SET_DIRECT_SAMPLING", "CMD_SET_OFFSET_TUNING", "CMD_SET_RTL_XTAL",
                 "CMD_SET_TUNER_XTAL", "CMD_SET_GAIN_BY_INDEX", "TUNER_UNKNOWN", "TUNER_E4000",
                 "TUNER_FC0012", "TUNER_FC0013", "TUNER_FC2580", "TUNER_R820T", "TUNER_R828D"):
        assert getattr(rt, name) == getattr(jrt, name), name
    rng = np.random.default_rng(11)
    for _ in range(64):
        cmd, param = int(rng.integers(0, 256)), int(rng.integers(-(1 << 31), 1 << 33))
        buf = rt.pack_command(cmd, param)
        assert buf == jrt.pack_command(cmd, param) and len(buf) == 5
        assert rt.unpack_command(buf) == jrt.unpack_command(buf) == (cmd, param & 0xFFFFFFFF)
    for tuner in range(7):
        for gains in (0, 5, 29):
            hdr = rt.pack_header(tuner, gains)
            assert hdr == jrt.pack_header(tuner, gains)
            assert hdr[:4] == b"RTL0" and struct.unpack(">II", hdr[4:]) == (tuner, gains)
    assert rt.pack_header() == jrt.pack_header()


def _raw_stream(mod_server, pkg_source, mod_client, nbytes):
    """Header and the first ``nbytes`` stream bytes a client of package
    ``mod_client`` reads from a server of ``mod_server``."""
    server, port = _serve(mod_server, _sim_source(pkg_source))
    client = mod_client.RtlTcpClient("127.0.0.1", port, timeout_s=30)
    try:
        return (client.tuner_type, client.tuner_gain_count), client._read_exact(nbytes)
    finally:
        client.close()


def test_stream_bytes_equal_and_cross_wired_clients():
    n = 3 * 8192 * 2 + 1000  # crosses chunk boundaries
    runs = {
        "port": _raw_stream(rt, "port", rt, n),
        "ref": _raw_stream(jrt, "ref", jrt, n),
        "port_client_ref_server": _raw_stream(jrt, "ref", rt, n),
        "ref_client_port_server": _raw_stream(rt, "port", jrt, n),
    }
    ref = runs["ref"]
    assert ref[0] == (jrt.TUNER_R820T, 29)
    assert len(set(ref[1])) >= 3  # a unit-RMS scene at scale 1: a few counts about mid-scale
    for way, got in runs.items():
        assert got == ref, way


@pytest.mark.parametrize("client_mod", [rt, jrt], ids=["port_client", "ref_client"])
def test_source_reads_decode_alike(client_mod):
    """``read_iq`` of either client on either server: the same complex64
    blocks (the decode is the same numpy arithmetic)."""
    blocks = []
    for server_mod, pkg in ((rt, "port"), (jrt, "ref")):
        server, port = _serve(server_mod, _sim_source(pkg, seed=4))
        client = client_mod.RtlTcpClient("127.0.0.1", port, timeout_s=30)
        try:
            blocks.append(client.read_iq(4096))
        finally:
            client.close()
    assert blocks[0].dtype == blocks[1].dtype == np.complex64 and blocks[0].shape == (4096,)
    np.testing.assert_array_equal(blocks[0], blocks[1])


def _wait_state(server, key, value):
    deadline = time.monotonic() + STATE_WAIT_S
    while server.state[key] != value and time.monotonic() < deadline:
        time.sleep(0.02)
    assert server.state[key] == value


@pytest.mark.parametrize("tuner", ["TUNER_FC0013", "TUNER_R820T", "TUNER_E4000"])
def test_server_state_after_the_same_commands(tuner):
    """The mode-command state machine (direct sampling, offset tuning, IF
    gain, gain by index, crystals, test mode) ends in equal ``state`` and
    equal source tuning in both packages."""
    states = []
    for pkg, (mod, _, _) in PKGS.items():
        source = _sim_source(pkg, seed=5)
        server, port = _serve(mod, source, tuner_type=getattr(mod, tuner))
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        try:
            assert sock.recv(12, socket.MSG_WAITALL) == mod.pack_header(getattr(mod, tuner))
            send = lambda cmd, p: sock.sendall(mod.pack_command(cmd, p))
            send(mod.CMD_SET_SAMPLE_RATE, 2_048_000)
            send(mod.CMD_SET_FREQ, 121_500_000)
            send(mod.CMD_SET_GAIN_MODE, 1)
            send(mod.CMD_SET_GAIN, 297)
            send(mod.CMD_SET_FREQ_CORRECTION, 17)
            send(mod.CMD_SET_AGC_MODE, 1)
            send(mod.CMD_SET_IF_GAIN, (3 << 16) | (0x10000 - 25))
            send(mod.CMD_SET_IF_GAIN, (1 << 16) | 60)
            send(mod.CMD_SET_OFFSET_TUNING, 1)
            send(mod.CMD_SET_GAIN_BY_INDEX, 5)
            send(mod.CMD_SET_GAIN_BY_INDEX, 500)
            send(mod.CMD_SET_RTL_XTAL, 28_799_000)
            send(mod.CMD_SET_TUNER_XTAL, 16_000_000)
            send(mod.CMD_SET_TEST_MODE, 1)
            send(mod.CMD_SET_TEST_MODE, 0)
            send(0x42, 7)  # unknown: logged, ignored
            send(mod.CMD_SET_DIRECT_SAMPLING, 2)
            send(mod.CMD_SET_FREQ, 3_570_000)
            _wait_state(server, "freq_hz", 3_570_000.0)
        finally:
            sock.close()
        states.append((dict(server.state), source.center_frequency_hz, source.sample_rate_hz))
    assert states[0] == states[1]
    assert states[0][0]["if_gain"] == {3: -25, 1: 60}


def test_client_tune_returns_the_same_plan():
    plans = []
    for pkg, (mod, _, _) in PKGS.items():
        server, port = _serve(mod, _sim_source(pkg, seed=4))
        client = mod.RtlTcpClient("127.0.0.1", port, timeout_s=30)
        try:
            plan = client.tune(121_500_000, 2_400_000, gain_tenth_db=300, ppm=3)
            client.read_iq(2048)  # the stream flows after the burst
            _wait_state(server, "gain", plan.gain_tenth_db)
            plans.append((plan.tuner, plan.gain_tenth_db, plan.sample_rate.real_rate_hz,
                          plan.lo.actual_hz, plan.lo.params, dict(server.state)))
        finally:
            client.close()
    assert plans[0] == plans[1]
    assert plans[0][:2] == ("r820t", 297)


def _dongle(pkg):
    mdl, cls = (model, Rtl2832uSource) if pkg == "port" else (jmodel, JRtl2832uSource)
    dev = mdl.open_model_device(mdl.TunerType.R820T)
    return dev, cls(dev, sample_rate_hz=2_048_000, center_frequency_hz=121_500_000)


def test_rtl2832u_source_through_both_servers():
    """The modeled dongle (counter test mode, then idle) → ``Rtl2832uSource``
    → each package's server → a client: the same bytes, a gap-free ramp,
    and a sample-rate command that programs the dongle to the same
    quantized rate."""
    from radio_mapper_tpu_torch.tools.sdr_test import DropStats

    got = []
    for pkg, (mod, _, _) in PKGS.items():
        dev, src = _dongle(pkg)
        assert src.sample_rate_hz == 2_048_000.0
        dev.set_testmode(True)
        server, port = _serve(mod, src)
        client = mod.RtlTcpClient("127.0.0.1", port, timeout_s=30)
        try:
            ramp = client._read_exact(4 * 2 * 4096)
            stats = DropStats()
            stats.update(np.frombuffer(ramp, np.uint8))
            assert stats.lost_bytes == 0 and stats.gaps == 0
            client.set_sample_rate(1_000_000)
            deadline = time.monotonic() + STATE_WAIT_S
            while src.sample_rate_hz == 2_048_000.0 and time.monotonic() < deadline:
                time.sleep(0.02)
            got.append((ramp, src.sample_rate_hz, dev.rate_hz, src.achieved_lo_hz))
        finally:
            client.close()
    assert got[0] == got[1]
    assert got[0][1] != 1_000_000 and abs(got[0][1] - 1_000_000) < 10


def test_rtl2832u_source_read_and_retune_alike():
    """``Rtl2832uSource`` on its own: reads (idle ADC and ramp), retunes and
    rate assignments agree with the reference's source, control transfer
    for control transfer."""
    runs = []
    for pkg in PKGS:
        dev, src = _dongle(pkg)
        out = [src.read(1000)]
        src.tune(433_920_000)
        dev.set_testmode(True)
        out.append(src.read(3000))
        src.sample_rate_hz = 2_400_000
        out += [src.achieved_lo_hz, src.sample_rate_hz, src.center_frequency_hz, src.power_offset_db]
        src.close()
        log = [(x.request_type, x.value, x.index, x.data) for x in dev.t.write_log]
        runs.append((out, log))
    (a, alog), (b, blog) = runs
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].dtype == np.complex64 and np.all(a[0] == a[0][0])  # idle mid-scale
    assert a[2:] == b[2:] and alog == blog
