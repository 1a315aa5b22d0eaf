"""The central service: the port's ``runtime.central.CentralProcessor`` vs
the JAX package's, fed the same wire messages of 4 simulated buoys through
``_dispatch`` (no socket is opened, no port bound), in waveform mode (u8
IQ snippets of one PPS-aligned dwell) and in timestamp mode; and the
port's copies of ``utils.metrics``, ``utils.storage``, ``runtime.alerts``
and the central datamodel records against the reference's.

Tolerances and why: the fix within 0.5 m, compared in ENU as
``tests/test_torch_tdoa_engine.py`` compares the engine (the reference
converts its fix to latitude and longitude in float32, a quantum of
~0.5 m; its ENU fix is captured at that conversion); the method,
``detected_by``, frequency and signal type equal; metric counters,
alerts, the HTTP handlers' bodies (ids, times and fix coordinates aside)
and the stored records equal.
"""

import asyncio
import dataclasses
import json
import sys

import numpy as np
import pytest

from radio_mapper_tpu import geo as jgeo
from radio_mapper_tpu.runtime import alerts as jalerts
from radio_mapper_tpu.runtime import central as jcentral
from radio_mapper_tpu.runtime import datamodel as jdm
from radio_mapper_tpu.utils import metrics as jmetrics
from radio_mapper_tpu.utils import storage as jstorage

from radio_mapper_tpu_torch import geo, sim
from radio_mapper_tpu_torch.runtime import alerts, central, datamodel
from radio_mapper_tpu_torch.utils import metrics, storage
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

EMITTER = (35.47, -97.51)
CLOCK_OFFSETS_NS = (80_000, -120_000, 40_000, -60_000)
T0_NS = 1_700_000_000_000_000_000
FS = 2_048_000.0


class _Socket:
    """A websocket stand-in: records what the service sends."""

    def __init__(self):
        self.sent = []

    async def send(self, msg):
        self.sent.append(json.loads(msg))


def _messages(with_iq, freq=121.5):
    """Registration, then one ``signal_detection`` a buoy, as buoys send
    them: clock-offset GPS stamps, ISO times of now, and (``with_iq``) a
    2048-sample u8 snippet of one dwell each."""
    scen = sim.default_scenario(emitter_lat=EMITTER[0], emitter_lng=EMITTER[1], signal="noise",
                                bandwidth_hz=150e3, snr_db=20.0, seed=3, sample_rate_hz=FS, block_len=2048)
    cap = sim.synthesize(scen)
    regs = [{"type": "node_registration", "node_id": b.buoy_id, "lat": b.lat, "lng": b.lng,
             "timing_accuracy_ns": 100_000} for b in scen.buoys]
    now = datamodel.utc_now_iso()
    dets = []
    for k, b in enumerate(scen.buoys):
        det = datamodel.SignalDetection(
            buoy_id=b.buoy_id, frequency_mhz=freq, signal_strength_dbm=-55.0, timestamp_utc=now,
            gps_timestamp_ns=T0_NS + int(cap.geometric_delays_s[k, 0] * 1e9) + CLOCK_OFFSETS_NS[k],
            lat=b.lat, lng=b.lng, confidence=0.9, signal_type="emergency",
            iq_samples=cap.iq[k].astype(np.complex64) if with_iq else None,
            iq_sample_rate_hz=FS if with_iq else 0.0, iq_anchor_ns=T0_NS + CLOCK_OFFSETS_NS[k])
        dets.append({"type": "signal_detection", "data": datamodel.detection_wire_dict(det, "u8")})
    return scen, regs, dets


def _drive(proc, regs, dets):
    """Every message through ``_dispatch`` on one loop, then the coalesced
    correlation pass run to its end."""
    sockets = {}

    async def run():
        for m in regs:
            sockets[m["node_id"]] = _Socket()
            await proc._dispatch(sockets[m["node_id"]], None, m)
        for m in dets:
            await proc._dispatch(sockets[m["data"]["buoy_id"]], m["data"]["buoy_id"], m)
            await proc._dispatch(sockets[m["data"]["buoy_id"]], None,
                                 {"type": "heartbeat", "node_id": m["data"]["buoy_id"]})
        while proc._corr_task is not None and not proc._corr_task.done():
            await proc._corr_task

    asyncio.run(run())
    return sockets


def _stamped(dets):
    """The detections stamped now, as buoys send them just before a drive:
    the service drops detections older than its 5 s correlation window
    against the wall clock, and one processor's drive can take most of
    that (the reference's waveform drive alone, 4.7 s on an idle CPU).
    Returns the messages and the stamp; IQ, GPS stamps and the window are
    untouched."""
    now = datamodel.utc_now_iso()
    return [{**m, "data": {**m["data"], "timestamp_utc": now}} for m in dets], now


def _as_ref(value, stamps):
    """``value`` (a stamp, or JSON-like records holding it) with the port's
    drive's stamp in place of the reference's, so the two compare equal
    where each service echoes the stamp it was sent."""
    ours, ref = stamps
    return json.loads(json.dumps(value).replace(json.dumps(ours)[1:-1], json.dumps(ref)[1:-1]))


def _run_both(tmp_path, monkeypatch, with_iq, **kw):
    """Both services driven by the same messages, each stamped just before
    its own drive. Returns ``(scen, ours, ref, seen, our_sockets,
    ref_sockets, stamps)``, stamps = (the port's, the reference's)."""
    scen, regs, dets = _messages(with_iq)
    seen = []
    convert = jgeo.enu_to_lat_lng

    def record(enu, *args):
        seen.append(np.asarray(enu, np.float64))
        return convert(enu, *args)

    monkeypatch.setattr(jgeo, "enu_to_lat_lng", record)
    mk = lambda mod, amod, smod, sub, **x: mod.CentralProcessor(
        host="127.0.0.1", ws_port=0, http_port=0, store=smod.SignalStore(str(tmp_path / sub)),
        alerter=amod.EmergencyAlerter(methods=["log"], confidence_threshold=0.0), **kw, **x)
    ref = mk(jcentral, jalerts, jstorage, "ref")
    ours = mk(central, alerts, storage, "ours", device="cpu")
    ref_dets, ref_stamp = _stamped(dets)
    ref_sockets = _drive(ref, regs, ref_dets)
    our_dets, our_stamp = _stamped(dets)
    our_sockets = _drive(ours, regs, our_dets)
    return scen, ours, ref, seen, our_sockets, ref_sockets, (our_stamp, ref_stamp)


def _hold_fixes(scen, ours, ref, seen, stamps):
    assert len(ours.triangulated_signals) == len(ref.triangulated_signals) == len(seen) == 1
    lat0 = float(np.mean([b.lat for b in scen.buoys]))  # the engine's ENU origin
    lng0 = float(np.mean([b.lng for b in scen.buoys]))
    for a, b, ref_enu in zip(ours.triangulated_signals, ref.triangulated_signals, seen):
        assert a.triangulation_method == b.triangulation_method
        assert a.detected_by == b.detected_by and len(a.detected_by) == 4
        assert (a.frequency_mhz, a.signal_type, _as_ref(a.detection_timestamps, stamps)) == (
            b.frequency_mhz, b.signal_type, b.detection_timestamps)
        enu = geo.lat_lng_to_enu_np(a.estimated_lat, a.estimated_lng, 0.0, lat0, lng0, 0.0)
        assert np.linalg.norm(enu[:2] - ref_enu[:2]) <= 0.5
        for f in ("accuracy_meters", "ellipse_major_m", "ellipse_minor_m"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-3)
        assert a.confidence == pytest.approx(b.confidence, abs=1e-3)
    return ours.triangulated_signals[0]


def _hold_service_state(ours, ref, our_sockets, ref_sockets):
    assert ours.metrics.snapshot()["counters"] == ref.metrics.snapshot()["counters"]
    assert set(ours.metrics.snapshot()["timers"]) == set(ref.metrics.snapshot()["timers"])
    assert ours.alerter.alerts_sent == ref.alerter.alerts_sent == 1
    assert ours.alerter._last_alert.keys() == ref.alerter._last_alert.keys()
    assert len(ours.signal_buffer) == len(ref.signal_buffer) == 4
    assert set(ours.nodes) == set(ref.nodes)
    for nid in our_sockets:
        kinds = [m["type"] for m in our_sockets[nid].sent]
        assert kinds == [m["type"] for m in ref_sockets[nid].sent]
        assert kinds.count("triangulation_result") == 1


@pytest.mark.parametrize("with_iq", [True, False], ids=["waveform", "timestamps"])
def test_central_matches_jax(tmp_path, monkeypatch, with_iq):
    scen, ours, ref, seen, our_sockets, ref_sockets, stamps = _run_both(tmp_path, monkeypatch, with_iq)
    fix = _hold_fixes(scen, ours, ref, seen, stamps)
    assert fix.triangulation_method == ("gcc-phat+lm" if with_iq else "hyperbolic-lm")
    if with_iq:
        err = geo.lat_lng_to_enu_np(fix.estimated_lat, fix.estimated_lng, 0.0, *EMITTER, 0.0)
        assert np.linalg.norm(err[:2]) < 100.0
    _hold_service_state(ours, ref, our_sockets, ref_sockets)
    # the snippets leave the working set with the window, not before
    assert all(d.iq_samples is not None for d in ours._recent) == with_iq


def test_http_handlers_match_jax(tmp_path, monkeypatch):
    """The API handlers called directly (no server): the same bodies."""
    _, ours, ref, _, _, _, _ = _run_both(tmp_path, monkeypatch, True)
    volatile = {"id", "lastSeen", "latest_signal_timestamp", "timestamp", "lat", "lng", "accuracy_meters",
                "ellipse_major_m", "ellipse_minor_m", "ellipse_orientation_deg", "confidence",
                "uptime_seconds", "server_time"}

    def body(proc, name):
        resp = asyncio.run(getattr(proc, name)(None))
        data = json.loads(resp.text)
        strip = lambda d: {k: v for k, v in d.items() if k not in volatile} if isinstance(d, dict) else d
        return [strip(d) for d in data] if isinstance(data, list) else strip(data)

    for name in ("api_nodes", "api_signals", "api_detections", "api_system_status"):
        assert body(ours, name) == body(ref, name), name
    text = lambda p: [ln for ln in asyncio.run(p.api_metrics(None)).text.splitlines() if "seconds" not in ln]
    assert text(ours) == text(ref)


def test_store_round_trip(tmp_path, monkeypatch):
    _, ours, ref, _, _, _, stamps = _run_both(tmp_path, monkeypatch, True)
    ours.store.close()
    ref.store.close()
    read = lambda sub, kind: [json.loads(ln) for p in sorted((tmp_path / sub).glob(f"{kind}-*.jsonl"))
                              for ln in p.read_text().splitlines()]
    assert _as_ref(read("ours", "detections"), stamps) == read("ref", "detections")
    fixes, jfixes = read("ours", "fixes"), read("ref", "fixes")
    assert [sorted(f) for f in fixes] == [sorted(f) for f in jfixes] and len(fixes) == 1
    # a restarted service resumes both from the port's files and the reference's
    for sub in ("ours", "ref"):
        again = central.CentralProcessor(host="127.0.0.1", ws_port=0, http_port=0, device="cpu",
                                         store=storage.SignalStore(str(tmp_path / sub)))
        assert [d.node_id for d in again.signal_buffer] == [d.node_id for d in ours.signal_buffer]
        assert [f.triangulation_method for f in again.triangulated_signals] == ["gcc-phat+lm"]
    assert storage.SignalStore(str(tmp_path / "ours")).load_fixes()[0] == dataclasses.replace(
        ours.triangulated_signals[0])


def test_correlation_passes_coalesce():
    """Triggers during a pass collapse into at most one follow-up pass."""
    proc = central.CentralProcessor(host="127.0.0.1", ws_port=0, http_port=0, device="cpu")
    calls = 0

    async def slow_pass():
        nonlocal calls
        calls += 1
        await asyncio.sleep(0.05)

    proc.process_signal_correlations = slow_pass

    async def run():
        for _ in range(10):
            proc._schedule_correlations()
            await asyncio.sleep(0.01)
        while proc._corr_task is not None and not proc._corr_task.done():
            await asyncio.sleep(0.01)

    asyncio.run(run())
    assert 1 <= calls <= 5, calls


def test_service_modules_stay_lazy():
    """The correlation path imports neither aiohttp nor websockets: a fresh
    interpreter imports the port's central module and runs a pass."""
    import subprocess

    code = (
        "import asyncio, sys\n"
        "from radio_mapper_tpu_torch.runtime import central\n"
        "p = central.CentralProcessor(device='cpu')\n"
        "asyncio.run(p.process_signal_correlations())\n"
        "bad = [m for m in ('aiohttp', 'websockets', 'requests') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --- the copies: metrics, storage, alerts, datamodel ---------------------------


def _spec(cls):
    return [(f.name, str(f.type), f.default, f.default_factory) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["LiveSignalDetection", "TriangulatedSignal", "UserSignalRequest",
                                  "BuoyStatus", "SignalDetection"])
def test_datamodel_records_equal_reference(name):
    assert _spec(getattr(datamodel, name)) == _spec(getattr(jdm, name))


def test_live_detection_from_message_equals_reference():
    _, _, dets = _messages(True)
    msg = dict(dets[0]["data"], correlation_id="x", iq_sample_file="y.bin")
    ours, ref = datamodel.LiveSignalDetection.from_message(msg), jdm.LiveSignalDetection.from_message(msg)
    a, b = dataclasses.asdict(ours), dataclasses.asdict(ref)
    np.testing.assert_array_equal(a.pop("iq_samples"), b.pop("iq_samples"))
    assert a == b and a["node_id"] == dets[0]["data"]["buoy_id"]


def test_metrics_equal_reference():
    regs = [metrics.MetricsRegistry(), jmetrics.MetricsRegistry()]
    for r in regs:
        r.inc("detections_received")
        r.inc("fixes.gcc-phat", 2.5)
        r.set_gauge("connected_nodes", 4)
        t = r.timer("triangulation")
        for s in (0.01, 0.03, 0.02, 0.5):
            t.observe(s)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].render_prometheus() == regs[1].render_prometheus()
    with regs[0].timer("ctx").time():
        pass
    assert regs[0].timer("ctx").snapshot()["count"] == 1


def _fix(mod, freq=121.5, conf=0.9, kind="emergency"):
    return mod.TriangulatedSignal(
        signal_id="SIG_1", frequency_mhz=freq, estimated_lat=35.47, estimated_lng=-97.51, confidence=conf,
        detected_by=["a", "b", "c"], detection_timestamps=[mod.utc_now_iso()], signal_type=kind,
        triangulation_method="gcc-phat+lm", accuracy_meters=12.0)


def test_alerts_equal_reference():
    posted = {0: [], 1: []}
    al = [alerts.EmergencyAlerter(methods=["log", "webhook"], webhook_url="http://hook",
                                  webhook_post=lambda u, p: posted[0].append((u, p["message"])),
                                  repeat_alert_minutes=1.0),
          jalerts.EmergencyAlerter(methods=["log", "webhook"], webhook_url="http://hook",
                                   webhook_post=lambda u, p: posted[1].append((u, p["message"])),
                                   repeat_alert_minutes=1.0)]
    mods = (datamodel, jdm)
    seq = [(dict(), 0.0), (dict(), 10.0), (dict(), 70.0), (dict(conf=0.5), 200.0), (dict(kind="voice"), 300.0),
           (dict(freq=406.025), 310.0)]
    got = [[a.process(_fix(m, **kw), now=t) for kw, t in seq] for a, m in zip(al, mods)]
    assert got[0] == got[1] == [True, False, True, False, False, True]
    assert posted[0] == posted[1] and al[0].alerts_sent == al[1].alerts_sent == 3


def test_storage_equal_reference(tmp_path):
    stores = [storage.SignalStore(str(tmp_path / "a")), jstorage.SignalStore(str(tmp_path / "b"))]
    for s, m in zip(stores, (datamodel, jdm)):
        det = m.LiveSignalDetection(node_id="n1", frequency_mhz=121.5, signal_strength_dbm=-50.0,
                                    timestamp_utc=m.utc_now_iso(), gps_timestamp_ns=1, lat=35.0, lng=-97.0,
                                    confidence=0.8, signal_type="emergency", iq_samples=[1 + 2j])
        s.append_detection(det)
        s.append_fix(_fix(m))
        s.close()
    for kind in ("detections", "fixes"):
        a = [json.loads(ln) for p in (tmp_path / "a").glob(f"{kind}-*.jsonl") for ln in p.read_text().splitlines()]
        b = [json.loads(ln) for p in (tmp_path / "b").glob(f"{kind}-*.jsonl") for ln in p.read_text().splitlines()]
        for r in a + b:
            r.pop("timestamp_utc", None)
            r.pop("detection_timestamps", None)
        assert a == b and len(a) == 1
    ours, ref = storage.SignalStore(str(tmp_path / "a")), jstorage.SignalStore(str(tmp_path / "b"))
    assert len(ours.load_detections()) == len(ref.load_detections()) == 1
    assert len(ours.load_fixes(window_s=3600)) == len(ref.load_fixes(window_s=3600)) == 1
    assert ours.cleanup() == ref.cleanup() == 0
