"""The buoy service: the port's ``runtime/buoy.py``, ``runtime/gps.py``,
the datamodel's wire half and the schedule constants vs the JAX package's.

- Constants, schedule, classifier, NMEA parsing, wire codecs and the
  messages a node sends: equal (host code copied; the JSON compared as
  text where no clock enters it, else with the clock's keys dropped).
- ``BuoyNode.detect_block`` on ``device="cpu"`` against the reference's
  ``detect_block`` in JAX safe mode (what the TPU runs): the same
  frequencies, confidences, types and bandwidths; the raw peak powers
  within 1e-3 dB (the same float32 spectrum from the same matmul
  four-step, summed in another order), so the reported strengths (rounded
  to 0.1 dB) within one rounding step.
- ``match_signal_pattern``: scores within 1e-5 (ratios of float32 sums of
  squares in [0, 1]), lags and order equal.
"""

import asyncio
import dataclasses
import json
import random
import time

import numpy as np
import pytest
import torch

from radio_mapper_tpu import constants as jconstants
from radio_mapper_tpu import sim as jsim
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.runtime import buoy as jbuoy
from radio_mapper_tpu.runtime import datamodel as jdm
from radio_mapper_tpu.runtime import gps as jgps

from radio_mapper_tpu_torch import constants, sim
from radio_mapper_tpu_torch.ingest import SimulatedSource
from radio_mapper_tpu_torch.runtime import buoy, datamodel, gps
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

# -- constants and schedule --------------------------------------------------


def test_schedule_and_classifier_equal_reference():
    ours = [dataclasses.astuple(e) for e in constants.DEFAULT_SCAN_SCHEDULE]
    assert ours == [dataclasses.astuple(e) for e in jconstants.DEFAULT_SCAN_SCHEDULE]
    assert [f.name for f in dataclasses.fields(constants.ScheduleEntry)] == [
        f.name for f in dataclasses.fields(jconstants.ScheduleEntry)]
    assert constants.schedule_cycle_s() == jconstants.schedule_cycle_s() == 35.0
    for t in np.arange(0.0, 80.0, 0.5):
        assert dataclasses.astuple(constants.frequency_at(t)) == dataclasses.astuple(jconstants.frequency_at(t))
    for f in (88.0, 105.7, 117.9, 118.0, 121.5, 136.0, 144.5, 156.8, 162.0, 243.0, 406.025, 406.2, 462.675):
        kind = constants.classify_frequency_mhz(f)
        assert kind == jconstants.classify_frequency_mhz(f)
        for t in (kind, "emergency", "public_safety", "fm_radio", "unknown"):
            assert constants.classification_label(f, t) == jconstants.classification_label(f, t)


# -- GPS ------------------------------------------------------------------------

NMEA = [
    "$GPGGA,123519,4807.038,N,01131.000,E,1,08,0.9,545.4,M,46.9,M,,*47",
    "$GPRMC,123519,A,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W*6A",
    "$GPRMC,123519,V,4807.038,N,01131.000,E,,,230394,,*00",
    "$GPGGA,123519,,N,01131.000,E,1,08,0.9,,M,46.9,M,,*47",
    "$GPGGA,123519,4807.038,S,01131.000,W,0,00,0.9,,M,46.9,M,,",
    "$GPGSV,3,1,11",
    "garbage",
    "$GPGGA,1,2",
]


@pytest.mark.parametrize("line", NMEA)
def test_nmea_parsing_equals_reference(line):
    ours, ref = gps.parse_nmea_sentence(line), jgps.parse_nmea_sentence(line)
    assert (ours is None) == (ref is None)
    if ours is not None:
        assert dataclasses.astuple(ours) == dataclasses.astuple(ref)
    for raw, hemi in (("3530.50", "N"), ("09732.00", "W"), ("4807.038", "S"), ("", "N"), ("12", "E"), ("1.5", "E")):
        assert gps.nmea_coord_to_decimal(raw, hemi) == jgps.nmea_coord_to_decimal(raw, hemi)


def test_gps_time_source_modes_equal_reference():
    for dev in (True, False):
        ours = gps.GPSTimeSource(35.55, -97.53, development_mode=dev, rng=random.Random(3), clock_offset_ns=250)
        ref = jgps.GPSTimeSource(35.55, -97.53, development_mode=dev, rng=random.Random(3), clock_offset_ns=250)
        assert ours.initialize() == ref.initialize() == dev
        assert (ours.gps_locked, ours.timing_accuracy_ns, ours.get_position()) == (
            ref.gps_locked, ref.timing_accuracy_ns, ref.get_position())
        iso, ns = ours.get_precise_timestamp()
        assert abs(ns - 250 - time.time_ns()) < 5e9 and iso.endswith("+00:00")
    assert gps.read_serial_fix("/dev/no-such-gps", timeout_s=0.1) is None  # no pyserial, or no device


# -- the wire ------------------------------------------------------------------


def _field_spec(cls):
    return [(f.name, str(f.type), f.default, f.default_factory) for f in dataclasses.fields(cls)]


def test_wire_records_equal_reference():
    assert _field_spec(datamodel.BuoyStatus) == _field_spec(jdm.BuoyStatus)
    assert _field_spec(buoy.BuoyNodeConfig) == _field_spec(jbuoy.BuoyNodeConfig)
    assert datamodel.IQ_WIRE_FORMATS == jdm.IQ_WIRE_FORMATS
    ts = "2026-01-02T03:04:05.5Z"
    assert datamodel.parse_iso(ts) == jdm.parse_iso(ts)
    obj = {"a": np.float32(1.5), "b": np.int64(3), "c": np.bool_(True), "d": np.arange(3),
           "e": np.array([1 + 2j, 3 - 4j], np.complex64), "f": 1 - 1j, "g": datamodel.parse_iso(ts)}
    assert json.dumps(obj, cls=datamodel.NumpyJSONEncoder) == json.dumps(obj, cls=jdm.NumpyJSONEncoder)
    status = dict(buoy_id="b", lat=1.0, lng=2.0, gps_locked=True, timing_accuracy_ns=5, sdr_active=False,
                  last_detection=None, uptime_seconds=1.5, signals_detected=2)
    assert datamodel.to_json(datamodel.BuoyStatus(**status)) == jdm.to_json(jdm.BuoyStatus(**status))


def _detection(mod, snippet, **kw):
    base = dict(buoy_id="b7", frequency_mhz=121.5, signal_strength_dbm=-51.2, timestamp_utc=datamodel.utc_now_iso(),
                gps_timestamp_ns=10**18, lat=35.5, lng=-97.5, confidence=0.8, signal_type="emergency",
                iq_samples=snippet, iq_sample_rate_hz=2.4e6 if snippet is not None else 0.0, iq_anchor_ns=7)
    base.update(kw)
    return mod.SignalDetection(**base)


@pytest.mark.parametrize("fmt", ["u8", "f16", "json"])
def test_iq_wire_codecs_and_detection_messages_equal_reference(fmt):
    rng = np.random.default_rng(1)
    snippet = (rng.normal(size=300) + 1j * rng.normal(size=300)).astype(np.complex64) * 3.0
    ours, extra = datamodel.encode_iq_wire(snippet, fmt)
    ref, jextra = jdm.encode_iq_wire(snippet, fmt)
    assert ours == ref and extra == jextra
    np.testing.assert_array_equal(datamodel.decode_iq_wire(ours, fmt, extra.get("iq_scale", 1.0)),
                                  jdm.decode_iq_wire(ref, fmt, jextra.get("iq_scale", 1.0)))
    det = _detection(datamodel, snippet)
    msg = datamodel.detection_wire_dict(det, fmt)
    assert json.dumps(msg, cls=datamodel.NumpyJSONEncoder) == json.dumps(
        jdm.detection_wire_dict(_detection(jdm, snippet, timestamp_utc=det.timestamp_utc), fmt),
        cls=jdm.NumpyJSONEncoder)
    # the central's record decodes the port's message
    live = jdm.LiveSignalDetection.from_message(json.loads(json.dumps(msg, cls=datamodel.NumpyJSONEncoder)))
    assert live.node_id == "b7" and live.iq_samples.shape == (300,)
    peak = np.abs(snippet.view(np.float32)).max()
    tol = {"u8": 2 * peak / 255, "f16": peak * 2.0**-11, "json": 0.0}[fmt]  # a count; half an f16 ulp at the peak
    assert np.abs(live.iq_samples - snippet).max() <= tol * 1.01
    no_iq = datamodel.detection_wire_dict(_detection(datamodel, None), fmt)
    assert no_iq["iq_samples"] is None and "iq_format" not in no_iq
    with pytest.raises(ValueError):
        datamodel.encode_iq_wire(snippet, "f64")


# -- the node -------------------------------------------------------------------


def _scenes(**kw):
    spec = dict(signal="fm", bandwidth_hz=16e3, freq_offset_hz=150e3, snr_db=25.0, seed=5, block_len=16_384)
    spec.update(kw)
    return sim.default_scenario(**spec), jsim.default_scenario(**spec)


def _nodes(cfg_kw=None, source=None, jsource=None):
    cfg_kw = dict(buoy_id="n0", lat=35.5, lng=-97.5, sample_rate_hz=2.048e6, **(cfg_kw or {}))
    ours = buoy.BuoyNode(buoy.BuoyNodeConfig(**cfg_kw), source=source, device="cpu")
    ref = jbuoy.BuoyNode(jbuoy.BuoyNodeConfig(**cfg_kw), source=jsource)
    return ours, ref


def _ref_detect(node, iq, center_hz):
    jsafe.set_safe_mode(True)
    try:
        return node.detect_block(iq, center_hz, 42)
    finally:
        jsafe.set_safe_mode(None)


@pytest.mark.parametrize("signal,offset_hz", [("fm", 150e3), ("tone", -250e3), ("bpsk", 300e3)])
def test_detect_block_matches_reference(signal, offset_hz):
    scen, jscen = _scenes(signal=signal, freq_offset_hz=offset_hz, bandwidth_hz=16e3 if signal != "bpsk" else 50e3)
    ours, ref = _nodes(source=SimulatedSource(scen, 1), jsource=None)
    ref.source = ours.source  # the offset rule reads the source's declared scale (40 dB)
    iq = ours.source.read(ours.config.block_len)
    center = scen.center_frequency_mhz * 1e6
    a = ours.detect_block(iq, center, 42)
    b = _ref_detect(ref, iq, center)
    assert len(a) == len(b) >= 1
    for x, y in zip(a, b):
        assert (x.frequency_mhz, x.confidence, x.signal_type, x.lat, x.lng, x.iq_anchor_ns, x.iq_sample_rate_hz) == (
            y.frequency_mhz, y.confidence, y.signal_type, y.lat, y.lng, y.iq_anchor_ns, y.iq_sample_rate_hz)
        assert abs(x.signal_strength_dbm - y.signal_strength_dbm) <= 0.1 + 1e-9
        np.testing.assert_array_equal(x.iq_samples, y.iq_samples)
    np.testing.assert_array_equal(ours.last_bandwidths_hz, ref.last_bandwidths_hz)
    assert abs(a[0].frequency_mhz - (scen.center_frequency_mhz + offset_hz / 1e6)) < 0.03  # inside the signal
    # the raw peak powers within 1e-3 dB
    to = lambda v: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    peaks, _ = ours._detector()(to(iq.real), to(iq.imag))
    jsafe.set_safe_mode(True)
    try:
        jpeaks, _ = ref._detector()(np.ascontiguousarray(iq.real, np.float32), np.ascontiguousarray(iq.imag, np.float32))
    finally:
        jsafe.set_safe_mode(None)
    v = peaks.valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(jpeaks.valid))
    np.testing.assert_allclose(peaks.power_db.numpy()[v], np.asarray(jpeaks.power_db)[v], atol=1e-3)
    assert ours._power_offset_db() == 40.0


def test_history_search_and_pattern_match_equal_reference():
    scen, _ = _scenes(signal="noise", bandwidth_hz=150e3, freq_offset_hz=0.0)
    ours, ref = _nodes()
    rng = np.random.default_rng(4)
    q = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)
    now = datamodel.utc_now_iso()
    old = "2000-01-01T00:00:00+00:00"
    entries = [  # (frequency, timestamp, snippet)
        (121.5, now, np.roll(q, 17) * 2.0), (121.5, now, (rng.normal(size=256) + 0j).astype(np.complex64)),
        (243.0, now, np.roll(q, -30) + 0.5 * q), (121.5, old, q), (156.8, now, None),
        (121.505, now, np.roll(q, 5)[:200]),
    ]
    for node, mod in ((ours, datamodel), (ref, jdm)):
        for f, ts, snip in entries:
            d = _detection(mod, None, frequency_mhz=f, timestamp_utc=ts)
            node.signal_history.append(d)
            node.snippet_history.append((d, snip))
    for kw in (dict(frequency_mhz=121.5), dict(frequency_range_mhz=(120.0, 130.0)), dict(), dict(max_age_minutes=0.0),
               dict(frequency_mhz=121.5, max_age_minutes=1e9)):
        assert [dataclasses.astuple(d) for d in ours.search_signal_history(**kw)] == [
            dataclasses.astuple(d) for d in ref.search_signal_history(**kw)]
    for kw in (dict(), dict(min_score=0.0), dict(frequency_mhz=121.5, min_score=0.1)):
        a, b = ours.match_signal_pattern(q, **kw), ref.match_signal_pattern(q, **kw)
        assert len(a) == len(b)
        for (da, sa, la), (db, sb, lb) in zip(a, b):
            assert dataclasses.astuple(da) == dataclasses.astuple(db) and la == lb
            assert abs(sa - sb) <= 1e-5
    best = ours.match_signal_pattern(q)
    assert best and best[0][2] == 17 and best[0][1] > 0.99
    assert ours.match_signal_pattern(q, frequency_mhz=99.0) == []


class _Broken:
    sample_rate_hz = 2_048_000.0
    center_frequency_hz = 121.5e6

    def tune(self, hz):
        raise OSError("usb gone")

    def read(self, n):
        raise OSError("usb gone")


def test_fallback_detections_on_a_failing_source_equal_reference():
    for fallback, dev in ((None, True), (True, False), (False, True), (None, False)):
        kw = dict(development_mode=dev, fallback_simulation=fallback)
        ours, ref = _nodes(kw, source=_Broken(), jsource=_Broken())
        got = []
        for node in (ours, ref):
            random.seed(9)
            got.append([asyncio.run(node.scan_once()) for _ in range(6)])
        a, b = ([d for dwell in g for d in dwell] for g in got)
        assert [(d.frequency_mhz, d.signal_strength_dbm, d.confidence, d.signal_type, d.buoy_id) for d in a] == [
            (d.frequency_mhz, d.signal_strength_dbm, d.confidence, d.signal_type, d.buoy_id) for d in b]
        if fallback or (fallback is None and dev):
            assert a and all(0.3 <= d.confidence <= 0.7 for d in a)
            assert len(ours.signal_history) == len(a) and all(s is None for _, s in ours.snippet_history)
        else:
            assert a == []


def test_scan_once_on_a_simulated_buoy():
    """``simulated_buoy`` tuned by its schedule to the scenario's channel:
    detections at the emitter's frequency, kept in the history with their
    snippet; a node without a source scans nothing."""
    scen, _ = _scenes(signal="tone", freq_offset_hz=250e3, snr_db=30.0)
    node = buoy.simulated_buoy(scen, 0, device="cpu")
    assert node.config.buoy_id == scen.buoys[0].buoy_id and node.config.development_mode
    assert node.source.pps_align_s == node.config.scan_interval_s
    node.gps.initialize()
    node.schedule = (constants.ScheduleEntry(121.5, 35.0, "emergency"),)
    dets = asyncio.run(node.scan_once())
    assert dets and abs(dets[0].frequency_mhz - 121.75) < 0.01
    assert dets[0].iq_anchor_ns > 0 and len(dets[0].iq_samples) == node.config.iq_snippet_samples
    assert len(node.signal_history) == len(node.snippet_history) == len(dets)
    assert node.snippet_history[0][1].shape == (node.config.snippet_samples,)
    node.source = None
    assert asyncio.run(node.scan_once()) == []


class _FakeWS:
    def __init__(self, node, stop_after=1, incoming=()):
        self.node, self.stop_after, self.sent, self.incoming = node, stop_after, [], list(incoming)

    async def send(self, m):
        self.sent.append(m)
        if len(self.sent) >= self.stop_after:
            self.node.running = False

    def __aiter__(self):
        return self._messages()

    async def _messages(self):
        for m in self.incoming:
            yield m


def _drop(msg, *keys):
    d = json.loads(msg)
    for k in keys:
        d.pop(k, None)
    return d


def test_comms_messages_equal_reference():
    rng = np.random.default_rng(2)
    snippet = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    ours, ref = _nodes(dict(development_mode=True, heartbeat_interval_s=0.0, gps_update_interval_s=0.0))
    ws = {}
    ts = datamodel.utc_now_iso()
    for node, mod in ((ours, datamodel), (ref, jdm)):
        node.gps.initialize()
        node.running = True
        w = ws[id(node)] = [_FakeWS(node) for _ in range(4)]
        asyncio.run(node._register(w[0]))
        node.queue.put_nowait(_detection(mod, snippet, timestamp_utc=ts))
        asyncio.run(node._send_loop(w[1]))
        node.running = True
        asyncio.run(node._heartbeat_loop(w[2]))
        node.running = True
        asyncio.run(node._gps_update_loop(w[3]))
    a, b = ws[id(ours)], ws[id(ref)]
    assert _drop(a[0].sent[0], "timestamp") == _drop(b[0].sent[0], "timestamp")
    assert a[1].sent == b[1].sent  # the detection, snippet encoded: the same text
    ha, hb = json.loads(a[2].sent[0]), json.loads(b[2].sent[0])
    for h in (ha, hb):
        h["status"].pop("uptime_seconds")
    assert ha == hb and ha["type"] == "heartbeat"
    assert _drop(a[3].sent[0], "timestamp") == _drop(b[3].sent[0], "timestamp")


def test_search_requests_answered_as_the_reference():
    q = (np.random.default_rng(6).normal(size=256) + 0j).astype(np.complex64)
    ours, ref = _nodes()
    ts = datamodel.utc_now_iso()
    for node, mod in ((ours, datamodel), (ref, jdm)):
        for k, snip in enumerate((np.roll(q, 3), q * 1j + 0.8 * np.roll(q[::-1], 7), None)):
            d = _detection(mod, None, frequency_mhz=121.5 + 0.001 * k, timestamp_utc=ts)
            node.signal_history.append(d)
            node.snippet_history.append((d, snip))
    requests = [
        {"type": "signal_search_request", "data": {"request_id": "r1", "frequency_mhz": 121.5}},
        {"type": "signal_search_request", "data": {"request_id": "r2", "frequency_range_mhz": [121.0, 122.0],
                                                    "iq_pattern": [[float(v.real), float(v.imag)] for v in q],
                                                    "min_score": 0.2}},
        {"type": "triangulation_result", "data": {"frequency_mhz": 121.5}},
        "not json",
    ]
    replies = []
    for node in (ours, ref):
        node.running = True
        w = _FakeWS(node, stop_after=99, incoming=[json.dumps(r) if isinstance(r, dict) else r for r in requests])
        asyncio.run(node._recv_loop(w))
        replies.append([json.loads(m) for m in w.sent])
    a, b = replies
    assert len(a) == len(b) == 2
    assert a[0] == b[0]
    for ma, mb in zip(a[1]["matches"], b[1]["matches"]):
        assert abs(ma.pop("match_score") - mb.pop("match_score")) <= 1e-5
    assert a[1] == b[1] and len(a[1]["matches"]) == 2
