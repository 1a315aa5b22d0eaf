"""The port's offline analyzer, autodetect, dashboard and the CLI's new
sources and subcommands, against the JAX package's on the same inputs.

- ``analyzer``: a synthetic tone capture (numpy ``default_rng``) through
  ``analyze_iq_file`` on ``device="cpu"`` (``torch.fft.fft`` in
  complex128) and the reference's numpy spectrum: the same peak bins and
  the same summary text; powers within 1e-9 dB (two float64 FFTs).
- ``config.autodetect``: the same report but for the accelerator entry,
  ``gpu`` from ``torch.cuda`` here.
- ``webapp``: the static files byte-equal, the same routes, the same mock
  payloads (timestamps aside), and both dashboards proxying the port's
  central service; every server an aiohttp ``AppRunner`` on port 0, its
  port read back from ``runner.addresses``.
- the CLI with ``--device cpu`` against ``radio_mapper_tpu.cli`` with
  ``--backend cpu``: ``usbprobe`` (every tuner), ``capture`` (usbmodel,
  sim, rtl_sdr without the binary), ``analyze``, ``eeprom``, ``setup``
  (the clock probe stubbed), ``test`` (its port checks on free ports),
  ``web`` (its app's arguments); ``buoy``, ``demod``, ``adsb`` and ``scan``
  over ``--source rtl_tcp`` from a server of the port on port 0, serving a
  source whose samples do not depend on when a retune lands, so both CLIs
  read the same bytes; ``buoy --source usbmodel``.

Tolerances: printed lines equal where they are deterministic; PCM within
2 LSB and scan dB within 1e-3 (``tests/test_torch_cli.py``'s limits);
the buoy's detections equal in frequency, confidence and type, strength
within 0.1 dB (``tests/test_torch_buoy.py``'s limits).
"""

import asyncio
import filecmp
import json
import os
import socket

import numpy as np
import pytest
import torch

from radio_mapper_tpu import analyzer as janalyzer
from radio_mapper_tpu import cli as jcli
from radio_mapper_tpu.config import autodetect as jautodetect
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.runtime import buoy as jbuoy
from radio_mapper_tpu.tools import power_scan as jscan
from radio_mapper_tpu.webapp import app as japp

from radio_mapper_tpu_torch import analyzer, cli, sim
from radio_mapper_tpu_torch.config import autodetect
from radio_mapper_tpu_torch.ingest.sources import IQSource
from radio_mapper_tpu_torch.net import rtl_tcp
from radio_mapper_tpu_torch.ops import adsb as adsb_ops
from radio_mapper_tpu_torch.ops import iq as iq_ops
from radio_mapper_tpu_torch.runtime import buoy
from radio_mapper_tpu_torch.tools import power_scan
from radio_mapper_tpu_torch.webapp import app
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


def _jax_main(argv):
    return jcli.main(["--backend", "cpu", *argv])


def _write_capture(path, tone_hz=200e3, fs=2_048_000.0, n=65536, seed=0):
    t = np.arange(n) / fs
    rng = np.random.default_rng(seed)
    data = 60.0 * np.exp(2j * np.pi * tone_hz * t) + 20.0 * np.exp(-2j * np.pi * 3 * tone_hz * t) + rng.normal(size=n)
    iq_ops.save_iq_bin(str(path), data)


# -- analyzer ------------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 65536), (1, 16384), (2, 50_000)])
def test_analyzer_equals_reference(tmp_path, seed, n):
    p = tmp_path / "iq_capture_a.bin"
    _write_capture(p, n=n, seed=seed)
    kw = dict(sample_rate_hz=2_048_000.0, center_frequency_hz=100e6)
    a = analyzer.analyze_iq_file(str(p), device="cpu", **kw)
    b = janalyzer.analyze_iq_file(str(p), **kw)
    assert a.peak_frequencies_hz == b.peak_frequencies_hz and len(a.peak_frequencies_hz) >= 2
    np.testing.assert_allclose(a.peak_powers_db, b.peak_powers_db, rtol=0, atol=1e-9)
    assert abs(a.mean_power_db - b.mean_power_db) <= 1e-9 and abs(a.max_power_db - b.max_power_db) <= 1e-9
    assert (a.num_samples, a.rms, a.dc_offset, a.path) == (b.num_samples, b.rms, b.dc_offset, b.path)
    assert a.summary() == b.summary()
    best = a.peak_frequencies_hz[int(np.argmax(a.peak_powers_db))]
    assert abs(best - 200e3) < 1e3


def test_analyzer_plot_and_directory(tmp_path):
    for k in range(2):
        _write_capture(tmp_path / f"iq_capture_{k}.bin", n=16384, seed=k)
    png = tmp_path / "spec.png"
    analyzer.analyze_iq_file(str(tmp_path / "iq_capture_0.bin"), plot_path=str(png), device="cpu")
    assert png.exists() and png.stat().st_size > 1000
    ours = analyzer.analyze_directory(str(tmp_path), device="cpu")
    ref = janalyzer.analyze_directory(str(tmp_path))
    assert [x.summary() for x in ours] == [x.summary() for x in ref] and len(ours) == 2


def test_analyzer_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = tmp_path / "c.bin"
    _write_capture(p, n=1024)
    with pytest.raises((RuntimeError, AssertionError)):
        analyzer.analyze_iq_file(str(p))


# -- autodetect ----------------------------------------------------------------


class _UdpSocket:
    """``socket`` stand-in for ``detect_local_ip``: records the connect
    (a UDP connect sends nothing, but no test here touches a public
    address) and answers a fixed local address."""

    AF_INET, SOCK_DGRAM = socket.AF_INET, socket.SOCK_DGRAM

    def __init__(self):
        self.connected = []

    def socket(self, *a):
        return self

    def connect(self, addr):
        self.connected.append(addr)

    def getsockname(self):
        return ("10.1.2.3", 40000)

    def close(self):
        pass


def _no_public_connect(monkeypatch):
    fake = _UdpSocket()
    for mod in (autodetect, jautodetect):
        monkeypatch.setattr(mod, "socket", fake)
    return fake


def test_autodetect_equals_reference_but_the_accelerator(monkeypatch):
    fake = _no_public_connect(monkeypatch)
    report = autodetect.auto_detect_interfaces()
    assert sorted(report) == ["gps_devices", "gpu", "local_ip", "sdr_count"]
    assert report["local_ip"] == jautodetect.detect_local_ip() == "10.1.2.3"
    assert fake.connected[0] == fake.connected[1]
    assert report["gps_devices"] == jautodetect.detect_gps_devices()
    assert report["sdr_count"] == jautodetect.detect_sdr_count()
    assert autodetect.detect_sdr_count(binary="definitely-not-a-binary") == 0
    if not torch.cuda.is_available():
        assert report["gpu"] == {"backend": "unavailable", "num_devices": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert autodetect.detect_gpu() == {"backend": "cuda", "num_devices": 2, "name": "NVIDIA H100 80GB HBM3"}


# -- webapp --------------------------------------------------------------------


def test_webapp_static_files_byte_equal():
    ours, ref = app.STATIC_DIR, japp.STATIC_DIR
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == ["app.js", "index.html"]
    match, mismatch, errors = filecmp.cmpfiles(ours, ref, ["app.js", "index.html"], shallow=False)
    assert match == ["app.js", "index.html"] and not mismatch and not errors


def _routes(web_app):
    return sorted((r.method, r.resource.canonical) for r in web_app.router.routes())


def test_webapp_routes_equal():
    assert _routes(app.WebApp().build_app()) == _routes(japp.WebApp().build_app())


_TIME_KEYS = {"lastSeen", "latest_signal_timestamp", "timestamp", "server_time", "uptime_seconds",
              "lastSeenFormatted"}


def _untimed(x):
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items() if k not in _TIME_KEYS}
    if isinstance(x, list):
        return [_untimed(v) for v in x]
    return x


@pytest.mark.parametrize("path", ["/api/nodes", "/api/detections", "/api/signals", "/api/system-status",
                                  "/api/search_signal", "/api/other"])
def test_webapp_mock_payloads_equal(path):
    ours, ref = app.WebApp._mock_payload(path), japp.WebApp._mock_payload(path)
    assert _untimed(ours) == _untimed(ref)
    assert json.dumps(ours)  # JSON-ready


async def _serve(web_app):
    from aiohttp import web

    runner = web.AppRunner(web_app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    host, port = runner.addresses[0][:2]
    return runner, f"http://{host}:{port}"


async def _fetch(http, base, path, method="GET", body=None):
    import aiohttp

    timeout = aiohttp.ClientTimeout(total=30)
    if method == "POST":
        async with http.post(base + path, data=body, headers={"Content-Type": "application/json"},
                             timeout=timeout) as r:
            return r.status, await r.read()
    async with http.get(base + path, timeout=timeout) as r:
        return r.status, await r.read()


def test_webapps_proxy_the_ports_central():
    """The port's dashboard and the reference's, both in front of the
    port's central service: every route answers alike."""
    from radio_mapper_tpu_torch.runtime.central import CentralProcessor

    async def run():
        import aiohttp

        central = CentralProcessor(host="127.0.0.1", device="cpu")
        crunner, curl = await _serve(central.build_http_app())
        runners = [crunner]
        try:
            sites = []
            for cls in (app.WebApp, japp.WebApp):
                r, url = await _serve(cls(curl, host="127.0.0.1").build_app())
                runners.append(r)
                sites.append(url)
            got = []
            async with aiohttp.ClientSession() as http:
                for url in sites:
                    out = {}
                    for path in ("/", "/static/app.js", "/api/nodes", "/api/signals", "/api/detections",
                                 "/api/system-status", "/api/devices", "/api/local-status"):
                        out[path] = await _fetch(http, url, path)
                    out["search"] = await _fetch(http, url, "/api/search_signal", "POST",
                                                 json.dumps({"frequency_mhz": 121.5}))
                    out["bad"] = await _fetch(http, url, "/api/search_signal", "POST", "{not json")
                    got.append(out)
        finally:
            for r in runners:
                await r.cleanup()
        return got

    ours, ref = asyncio.run(run())
    assert ours.keys() == ref.keys()
    for key in ours:
        (s1, b1), (s2, b2) = ours[key], ref[key]
        assert s1 == s2, key
        if key in ("/", "/static/app.js"):
            assert b1 == b2, key
        else:
            assert _untimed(json.loads(b1)) == _untimed(json.loads(b2)), key
    assert ours["/"][0] == 200 and b"leaflet" in ours["/"][1].lower()
    assert json.loads(ours["/api/nodes"][1]) == [] and json.loads(ours["/api/system-status"][1])["connected_nodes"] == 0
    assert "gps_devices" in json.loads(ours["/api/local-status"][1])
    assert ours["bad"][0] == 400


@pytest.mark.parametrize("dev_mock", [False, True])
def test_webapp_unreachable_central(dev_mock):
    """A central that refuses connections: 502 with the error, or the mock
    payloads with ``dev_mock`` — alike in both packages."""
    with socket.socket() as s:  # a port that was free and is closed again
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"

    async def run():
        import aiohttp

        runners, got = [], []
        try:
            for cls in (app.WebApp, japp.WebApp):
                r, url = await _serve(cls(dead, host="127.0.0.1", dev_mock=dev_mock).build_app())
                runners.append(r)
                async with aiohttp.ClientSession() as http:
                    got.append({p: await _fetch(http, url, p) for p in ("/api/nodes", "/api/system-status",
                                                                          "/api/devices")})
        finally:
            for r in runners:
                await r.cleanup()
        return got

    ours, ref = asyncio.run(run())
    for key in ours:
        assert ours[key][0] == ref[key][0] == (200 if dev_mock or key == "/api/devices" else 502), key
        a, b = json.loads(ours[key][1]), json.loads(ref[key][1])
        if dev_mock or key == "/api/devices":
            assert _untimed(a) == _untimed(b)
        else:
            assert a["error"].startswith("central unavailable") and b["error"].startswith("central unavailable")
    if dev_mock:
        assert len(json.loads(ours["/api/nodes"][1])) == 3


# -- the CLI: subcommands without a receiver -----------------------------------


@pytest.mark.parametrize("tuner", ["e4000", "fc0012", "fc0013", "fc2580", "r820t", "r828d", "unknown"])
def test_usbprobe_prints_the_reference_lines(capsys, tuner):
    argv = ["usbprobe", "--tuner", tuner, "--freq", "433.92e6", "--rate", "2400000", "--gain", "250"]
    cli.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    _jax_main(argv)
    assert out == capsys.readouterr().out
    assert f"tuner: {tuner.upper()}" in out and "0 lost, 0 gaps" in out


@pytest.mark.parametrize("source", ["usbmodel", "sim"])
def test_capture_and_analyze_equal_reference(tmp_path, capsys, source):
    files = {}
    outs = []
    for who, main in (("ours", lambda a: cli.main(["--device", "cpu", *a])), ("ref", _jax_main)):
        path = tmp_path / f"{who}.bin"
        main(["capture", "--source", source, "--samples", "32768", "--frequency", "121.5",
              "--sample-rate", "2400000", "--output", str(path)])
        main(["analyze", str(path), "--frequency", "121.5", "--sample-rate", "2400000"])
        outs.append(capsys.readouterr().out.replace(str(path), "X"))
        files[who] = path.read_bytes()
    assert files["ours"] == files["ref"] and len(files["ours"]) == 2 * 32768
    assert outs[0] == outs[1]
    if source == "usbmodel":
        assert "via the L0 driver stack" in outs[0] and "rate 2400000.000 Hz" in outs[0]


def test_capture_rtl_sdr_without_the_binary(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # no rtl_sdr on this PATH
    codes = []
    for main in (lambda a: cli.main(["--device", "cpu", *a]), _jax_main):
        with pytest.raises(SystemExit) as e:
            main(["capture", "--source", "rtl_sdr", "--samples", "1024", "--output", str(tmp_path / "x.bin")])
        codes.append((e.value.code, capsys.readouterr().out))
    assert codes[0] == codes[1] and codes[0][0] == 1
    assert "rtl_sdr binary not found" in codes[0][1]


def test_eeprom_subcommand_round_trip(tmp_path, capsys):
    outs = []
    for who, main in (("ours", lambda a: cli.main(["--device", "cpu", *a])), ("ref", _jax_main)):
        img = tmp_path / f"{who}.bin"
        for argv in (["eeprom", "--generate", "realtek_oem", "--serial", "BUOY07", "--out", str(img)],
                     ["eeprom", "--read", str(img)]):
            with pytest.raises(SystemExit) as e:
                main(argv)
            assert e.value.code == 0
        outs.append((capsys.readouterr().out.replace(str(img), "X"), img.read_bytes()))
    assert outs[0] == outs[1] and "BUOY07" in outs[0][0]


def test_setup_equals_reference(tmp_path, capsys, monkeypatch):
    _no_public_connect(monkeypatch)
    for mod in (cli, jcli):
        monkeypatch.setattr(mod, "_check_time_sync", lambda: "stub: synchronized")
    ours, ref = tmp_path / "ours.yaml", tmp_path / "ref.yaml"
    cli.main(["--device", "cpu", "setup", "--output", str(ours)])
    out = capsys.readouterr().out
    _jax_main(["setup", "--output", str(ref)])
    jout = capsys.readouterr().out
    drop = lambda s, p, key: [ln for ln in s.replace(str(p), "X").splitlines() if not ln.startswith(f"  {key}:")]
    assert drop(out, ours, "gpu") == drop(jout, ref, "tpu")
    assert "  gpu: {" in out and "method: gps (target 1 us, max 100 us)" in out
    assert ours.read_bytes() == ref.read_bytes()


def test_check_time_sync_reports_a_probe(monkeypatch):
    """The clock probe with no probe tool installed, in both packages."""
    import shutil

    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert cli._check_time_sync() == jcli._check_time_sync() == "unavailable (no timedatectl/chronyc/ntpdate)"


def test_selftest_on_the_cpu(capsys, monkeypatch):
    _no_public_connect(monkeypatch)
    free = []
    for _ in range(3):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            free.append(s.getsockname()[1])
    monkeypatch.setattr(cli, "SERVICE_PORTS", tuple(free))
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "test"])
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    assert "[FAIL]" not in out
    for line in ("  [PASS] config defaults validate", "  [PASS] import torch — torch",
                 "  [PASS] torch device — torch ", "  [PASS] pipeline smoke (tiny) — ok",
                 "  [PASS] USB bring-up + counter test (device model) — R820T @ 2048000 Hz, 0 dropped",
                 "  gpu: {", "  sdr count: 0", f"  [PASS] port {free[0]} available"):
        assert line in out, line
    assert [ln for ln in out.splitlines() if not ln.startswith(" ")] == [
        "Configuration:", "Dependencies:", "Compute:", "L0 driver stack:", "Hardware:", "Ports:"]
    assert cli._pipeline_smoke(torch.device("cpu")) == "ok"
    assert cli._l0_smoke() == jcli._l0_smoke()


def test_web_subcommand_builds_the_reference_app(monkeypatch):
    seen = []

    async def fake_run_forever(self):
        seen.append((self.central_http_url, self.host, self.port, self.dev_mock))

    monkeypatch.setattr(app.WebApp, "run_forever", fake_run_forever)
    monkeypatch.setattr(japp.WebApp, "run_forever", fake_run_forever)
    for argv in (["web"], ["web", "--central", "http://10.0.0.2:4000/", "--host", "127.0.0.1", "--port", "7311",
                           "--mock"]):
        cli.main(["--device", "cpu", *argv])
        _jax_main(argv)
    assert seen[0] == seen[1] == ("http://localhost:4000", "0.0.0.0", 7000, False)
    assert seen[2] == seen[3] == ("http://10.0.0.2:4000", "127.0.0.1", 7311, True)


# -- the CLI over rtl_tcp and the modeled dongle -------------------------------


class _LoopSource(IQSource):
    """Serves a fixed buffer cyclically whatever it is tuned to, so the
    bytes a client reads do not depend on when its commands land."""

    def __init__(self, buf, sample_rate_hz):
        self.buf, self.pos = np.asarray(buf, np.complex64), 0
        self.sample_rate_hz, self.center_frequency_hz = float(sample_rate_hz), 0.0

    def read(self, n):
        idx = (self.pos + np.arange(n)) % self.buf.size
        self.pos = int((self.pos + n) % self.buf.size)
        return self.buf[idx]


def _server(buf, rate):
    server = rtl_tcp.RtlTcpServer(_LoopSource(buf, rate), host="127.0.0.1", port=0, throttle=False)
    rtl_tcp.serve_in_thread(server)
    return f"127.0.0.1:{server.port}"


def _fm_buffer(n=1 << 17):
    scen = sim.default_scenario(signal="fm", bandwidth_hz=16e3, freq_offset_hz=150e3, snr_db=25.0, seed=5,
                                block_len=n)
    return sim.synthesize(scen).iq[0]


def test_demod_over_rtl_tcp_equals_reference(tmp_path, capsys):
    buf = _fm_buffer()
    argv = ["demod", "--source", "rtl_tcp", "--mode", "nbfm", "--frequency", "121.65", "--sample-rate",
            "1024000", "--seconds", "0.05"]
    cli.main(["--device", "cpu", *argv, "--rtl-tcp", _server(buf, 1_024_000), "--output", str(tmp_path / "a.pcm")])
    out = capsys.readouterr().out
    _jax_main([*argv, "--rtl-tcp", _server(buf, 1_024_000), "--output", str(tmp_path / "b.pcm")])
    jout = capsys.readouterr().out
    assert out.replace("a.pcm", "X") == jout.replace("b.pcm", "X")
    a, b = np.fromfile(tmp_path / "a.pcm", np.int16), np.fromfile(tmp_path / "b.pcm", np.int16)
    assert a.size == b.size > 0 and np.abs(a.astype(np.int32) - b).max() <= 2


def test_adsb_over_rtl_tcp_equals_reference(capsys):
    frames = ["8d4840d6202cc371c32ce057", "8d40621d58c382d690c8ac28"]
    blk = np.concatenate([adsb_ops.encode_frame_iq(adsb_ops.append_crc(f), noise=0.02, seed=k)
                          for k, f in enumerate(frames)])
    buf = 60.0 * np.concatenate([blk, np.zeros((1 << 18) - blk.size, np.complex64)])
    cli.main(["--device", "cpu", "adsb", "--source", "rtl_tcp", "--blocks", "2", "--rtl-tcp",
              _server(buf, adsb_ops.ADSB_RATE_HZ)])
    out = capsys.readouterr().out
    _jax_main(["adsb", "--source", "rtl_tcp", "--blocks", "2", "--rtl-tcp", _server(buf, adsb_ops.ADSB_RATE_HZ)])
    assert out == capsys.readouterr().out
    assert len(out.splitlines()) == 4 and out.splitlines()[0] == "*8d4840d6202cc371c32ce0576098;"


def test_scan_over_rtl_tcp_equals_reference(monkeypatch, capsys):
    ours, ref = [], []
    for mod, sink in ((power_scan, ours), (jscan, ref)):
        orig = mod.run_scan
        monkeypatch.setattr(mod, "run_scan", lambda *a, _o=orig, _s=sink, **k: _s.append(_o(*a, **k)) or _s[-1])
    buf = _fm_buffer()
    argv = ["scan", "120.5", "122.5", "--source", "rtl_tcp", "--integration", "0.05"]
    cli.main(["--device", "cpu", *argv, "--rtl-tcp", _server(buf, 2_048_000)])
    rows = capsys.readouterr().out.splitlines()
    _jax_main([*argv, "--rtl-tcp", _server(buf, 2_048_000)])
    jrows = capsys.readouterr().out.splitlines()
    assert len(rows) == len(jrows) == 2
    for r, j in zip(rows, jrows):
        assert r.split(", ")[2:6] == j.split(", ")[2:6]
        vals = lambda s: np.array([float(v) for v in s.split(", ")[6:]])
        assert np.abs(vals(r) - vals(j)).max() <= 0.0100001
    for a, b in zip(ours[0].power_db, ref[0].power_db):
        assert np.abs(a - b).max() <= 1e-3


def _one_dwell(mod, record, frequency_mhz, testmode=False):
    """``BuoyNode.run`` replaced by one ``scan_once`` on ``frequency_mhz``
    (with the modeled dongle's counter test mode on, if asked)."""

    async def run(self):
        if testmode:
            self.source.dev.set_testmode(True)
        self.gps.initialize()
        self.schedule = (mod.constants.ScheduleEntry(frequency_mhz, 35.0, "emergency"),)
        record.append((self, await self.scan_once()))
        self.source.close()

    return run


def test_buoy_over_rtl_tcp_equals_reference(monkeypatch):
    """``buoy --source rtl_tcp`` end to end on the CPU: the port's node,
    its detection dwell (K7's plain version) and the reference's node on
    the TPU's routing read the same bytes and detect alike."""
    jsafe.set_safe_mode(True)
    try:
        got = {}
        buf = _fm_buffer()
        for who, mod, main in (("ours", buoy, lambda a: cli.main(["--device", "cpu", *a])), ("ref", jbuoy, _jax_main)):
            rec = []
            monkeypatch.setattr(mod.BuoyNode, "run", _one_dwell(mod, rec, 121.5))
            main(["buoy", "--source", "rtl_tcp", "--rtl-tcp", _server(buf, 2_048_000), "--id", "n7"])
            got[who] = rec[0]
    finally:
        jsafe.set_safe_mode(None)
    (node, a), (jnode, b) = got["ours"], got["ref"]
    assert type(node.source).__name__ == type(jnode.source).__name__ == "RtlTcpSource"
    assert node.config.sample_rate_hz == jnode.config.sample_rate_hz == 2_048_000.0
    assert len(a) == len(b) >= 1
    for x, y in zip(a, b):
        assert (x.frequency_mhz, x.confidence, x.signal_type, x.buoy_id) == (
            y.frequency_mhz, y.confidence, y.signal_type, y.buoy_id)
        assert abs(x.signal_strength_dbm - y.signal_strength_dbm) <= 0.1 + 1e-9
    assert abs(a[0].frequency_mhz - 121.65) < 0.03


def test_buoy_over_the_modeled_dongle(monkeypatch):
    """``buoy --source usbmodel``: the node runs at the dongle's quantized
    rate, as the reference's does, and detects alike on the dongle's
    counter test pattern (a complex sawtooth: its harmonics every
    fs/128). The idle model's constant bytes are no test: all that rises
    above its notch is float32 rounding residue."""
    jsafe.set_safe_mode(True)
    try:
        got = {}
        for who, mod, main in (("ours", buoy, lambda a: cli.main(["--device", "cpu", *a])), ("ref", jbuoy, _jax_main)):
            rec = []
            monkeypatch.setattr(mod.BuoyNode, "run", _one_dwell(mod, rec, 121.5, testmode=True))
            main(["buoy", "--source", "usbmodel", "--sample-rate", "1000000"])
            got[who] = rec[0]
    finally:
        jsafe.set_safe_mode(None)
    (node, a), (jnode, b) = got["ours"], got["ref"]
    assert type(node.source).__name__ == "Rtl2832uSource"
    assert node.config.sample_rate_hz == jnode.config.sample_rate_hz != 1_000_000.0
    assert abs(node.config.sample_rate_hz - 1_000_000.0) < 10
    assert node.source.achieved_lo_hz == jnode.source.achieved_lo_hz
    # the sawtooth is real times (1 + j): its ± harmonics tie in exact
    # arithmetic, and rounding orders each pair, so compare by frequency
    a, b = (sorted(d, key=lambda x: x.frequency_mhz) for d in (a, b))
    assert len(a) == len(b) >= 1
    for x, y in zip(a, b):
        assert (x.frequency_mhz, x.confidence, x.signal_type) == (y.frequency_mhz, y.confidence, y.signal_type)
        assert abs(x.signal_strength_dbm - y.signal_strength_dbm) <= 0.1 + 1e-9


@pytest.mark.parametrize("argv", [["usbprobe"], ["capture", "--source", "sim"], ["analyze", "x.bin"],
                                  ["sdrtest"], ["eeprom", "--generate", "realtek"], ["setup"], ["test"], ["web"]])
def test_new_subcommands_raise_on_cuda_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
