"""The central node's TDOA engine: the port's ``runtime.tdoa_engine`` vs
the JAX package's on one simulated detection group, in waveform mode
(IQ snippets through the all-pairs GCC-PHAT) and timestamp mode; the
port's copies of the datamodel and the engine's constants against the
reference's; and the float64 ``geo.enu_to_lat_lng``.

The reference converts its fix to latitude and longitude in float32 (its
``geo`` is jnp, x64 off), a quantum of ~0.5 m at ECEF magnitudes; the
port does it in float64. So the fixes are compared in ENU, as the
solvers return them (the reference's captured at its ``enu_to_lat_lng``
call), and the conversion is held to the reference's formula under x64.

Tolerances and why: waveform Δt within 1 ns (both round τ to whole ns)
and distance differences within 1e-3 samples' worth (the lag tolerance
of the other GCC tests); confidences within 1e-3; the ENU fix within
0.5 m; the ellipse and the residual RMS within 1e-3 relative (float32
solves on the same inputs); the geodesy within 1e-9 degrees and 1 µm.
"""

import dataclasses

import numpy as np
import pytest

from jax import enable_x64

from radio_mapper_tpu import constants as jconstants
from radio_mapper_tpu import geo as jgeo
from radio_mapper_tpu.runtime import datamodel as jdm
from radio_mapper_tpu.runtime import tdoa_engine as jeng

from radio_mapper_tpu_torch import constants, geo, sim
from radio_mapper_tpu_torch.runtime import datamodel, tdoa_engine
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

EMITTER = (35.47, -97.51)
CLOCK_OFFSETS_NS = (80_000, -120_000, 40_000, -60_000)  # ±100 µs-class clock-reading errors
T0_NS = 1_700_000_000_000_000_000
FS = 2.4e6


@pytest.fixture(scope="module")
def scene():
    """4 OKC buoys, a 150 kHz noise emitter at 20 dB, 16384 samples at 2.4 MS/s."""
    scen = sim.default_scenario(emitter_lat=EMITTER[0], emitter_lng=EMITTER[1], signal="noise",
                                bandwidth_hz=150e3, snr_db=20.0, seed=3, sample_rate_hz=FS)
    return scen, sim.synthesize(scen)


def _detections(dm, scen, cap, *, with_iq=True):
    """Detections as buoys emit them: clock-offset timestamps and, with
    ``with_iq``, the 16384-sample snippets of one PPS-aligned dwell."""
    return [
        dm.SignalDetection(
            buoy_id=b.buoy_id, frequency_mhz=121.5, signal_strength_dbm=-55.0,
            timestamp_utc="2026-08-17T00:00:00+00:00",
            gps_timestamp_ns=T0_NS + int(cap.geometric_delays_s[k, 0] * 1e9) + CLOCK_OFFSETS_NS[k],
            lat=b.lat, lng=b.lng, confidence=0.9, signal_type="emergency",
            iq_samples=cap.iq[k].astype(np.complex64) if with_iq else None,
            iq_sample_rate_hz=FS if with_iq else 0.0,
            iq_anchor_ns=T0_NS + CLOCK_OFFSETS_NS[k],
        )
        for k, b in enumerate(scen.buoys)
    ]


def _engine(mod, dm, scen, **kw):
    eng = mod.TDoAEngine(**kw)
    for b in scen.buoys:
        eng.register_buoy(dm.BuoyPosition(b.buoy_id, b.lat, b.lng, b.alt_m, 100_000))
    return eng


def _run_both(scen, cap, monkeypatch, *, with_iq=True, **kw):
    """Both engines on the same group; the reference's ENU fix captured at
    its conversion to latitude and longitude."""
    seen = []
    convert = jgeo.enu_to_lat_lng

    def record(enu, *args):
        seen.append(np.asarray(enu, np.float64))
        return convert(enu, *args)

    monkeypatch.setattr(jgeo, "enu_to_lat_lng", record)
    ref = _engine(jeng, jdm, scen, **kw).process_signal_detections(_detections(jdm, scen, cap, with_iq=with_iq))
    ours = _engine(tdoa_engine, datamodel, scen, device="cpu", **kw).process_signal_detections(
        _detections(datamodel, scen, cap, with_iq=with_iq)
    )
    assert len(ref) == len(ours) == 1 and len(seen) == 1
    return ours[0], ref[0], seen[0]


def _assert_results_match(scen, ours, ref, ref_enu, dd_tol_m):
    assert ours.method == ref.method
    assert ours.contributing_buoys == ref.contributing_buoys
    assert (ours.signal_type, ours.frequency_mhz) == (ref.signal_type, ref.frequency_mhz)
    assert len(ours.tdoa_measurements) == len(ref.tdoa_measurements) == 6
    for m, r in zip(ours.tdoa_measurements, ref.tdoa_measurements):
        assert (m.buoy1_id, m.buoy2_id, m.frequency_mhz) == (r.buoy1_id, r.buoy2_id, r.frequency_mhz)
        assert abs(m.time_difference_ns - r.time_difference_ns) <= 1
        assert abs(m.distance_difference_m - r.distance_difference_m) <= dd_tol_m
        assert abs(m.confidence - r.confidence) <= 1e-3
    lat0 = float(np.mean([b.lat for b in scen.buoys]))  # the solve's ENU origin
    lng0 = float(np.mean([b.lng for b in scen.buoys]))
    enu = geo.lat_lng_to_enu_np(ours.estimated_lat, ours.estimated_lng, ours.estimated_altitude, lat0, lng0, 0.0)
    np.testing.assert_allclose(enu, ref_enu, atol=0.5)
    for f in ("accuracy_meters", "ellipse_major_m", "ellipse_minor_m"):
        np.testing.assert_allclose(getattr(ours, f), getattr(ref, f), rtol=1e-3, err_msg=f)
    assert abs(ours.confidence - ref.confidence) <= 1e-3


def test_waveform_mode_matches_jax(scene, monkeypatch):
    scen, cap = scene
    ours, ref, ref_enu = _run_both(scen, cap, monkeypatch)
    assert ours.method == "gcc-phat+lm"
    _assert_results_match(scen, ours, ref, ref_enu, dd_tol_m=1e-3 * constants.SPEED_OF_LIGHT_M_S / FS)
    err = geo.lat_lng_to_enu_np(ours.estimated_lat, ours.estimated_lng, 0.0, *EMITTER, 0.0)
    assert np.linalg.norm(err[:2]) < 50.0, err


def test_timestamp_mode_matches_jax(scene, monkeypatch):
    scen, cap = scene
    ours, ref, ref_enu = _run_both(scen, cap, monkeypatch, waveform_mode="never")
    assert ours.method == "hyperbolic-lm"
    _assert_results_match(scen, ours, ref, ref_enu, dd_tol_m=0.0)
    # without snippets "auto" falls back to timestamps, and "always" refuses
    ours_auto, _, _ = _run_both(scen, cap, monkeypatch, with_iq=False)
    assert ours_auto.method == "hyperbolic-lm"
    eng = _engine(tdoa_engine, datamodel, scen, device="cpu", waveform_mode="always")
    assert eng.process_signal_detections(_detections(datamodel, scen, cap, with_iq=False)) == []


def test_engine_helpers_match_jax(scene):
    scen, cap = scene
    ours = _detections(datamodel, scen, cap, with_iq=False)
    ref = _detections(jdm, scen, cap, with_iq=False)
    ours[1] = dataclasses.replace(ours[1], frequency_mhz=121.505)
    ref[1] = dataclasses.replace(ref[1], frequency_mhz=121.505)
    ours[2] = dataclasses.replace(ours[2], frequency_mhz=156.8, gps_timestamp_ns=T0_NS - int(60e9))
    ref[2] = dataclasses.replace(ref[2], frequency_mhz=156.8, gps_timestamp_ns=T0_NS - int(60e9))
    g, rg = tdoa_engine.group_by_frequency(ours), jeng.group_by_frequency(ref)
    assert {f: [d.buoy_id for d in v] for f, v in g.items()} == {f: [d.buoy_id for d in v] for f, v in rg.items()}
    kept = [d.buoy_id for d in tdoa_engine.filter_time_window(ours, 10.0)]
    assert kept == [d.buoy_id for d in jeng.filter_time_window(ref, 10.0)] and len(kept) == 3
    assert tdoa_engine.filter_time_window([], 10.0) == []
    b1, b2 = (datamodel.BuoyPosition("a", 0, 0, 0, 1000), datamodel.BuoyPosition("b", 0, 0, 0, 70_000))
    assert tdoa_engine.timing_confidence(b1, b2) == jeng.timing_confidence(
        jdm.BuoyPosition("a", 0, 0, 0, 1000), jdm.BuoyPosition("b", 0, 0, 0, 70_000))
    eng = _engine(tdoa_engine, datamodel, scen, device="cpu")
    status = eng.get_network_status()
    assert status == _engine(jeng, jdm, scen).get_network_status()
    assert status["triangulation_ready"]
    few = tdoa_engine.TDoAEngine(device="cpu")
    for b in scen.buoys[:2]:
        few.register_buoy(datamodel.BuoyPosition(b.buoy_id, b.lat, b.lng, b.alt_m, 1000))
    assert few.process_signal_detections(_detections(datamodel, scen, cap)) == []
    with pytest.raises(ValueError):
        tdoa_engine.TDoAEngine(waveform_mode="sometimes", device="cpu")


def _field_spec(cls):
    return [(f.name, str(f.type), f.default, f.default_factory) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["BuoyPosition", "SignalDetection", "TDoAMeasurement", "TriangulationResult"])
def test_datamodel_copy_equals_reference(name):
    assert _field_spec(getattr(datamodel, name)) == _field_spec(getattr(jdm, name))


def test_engine_constants_equal_reference():
    for name in ("DEFAULT_MIN_BUOYS", "DEFAULT_MAX_BASELINE_KM", "DEFAULT_FREQ_TOLERANCE_MHZ",
                 "DEFAULT_CORRELATION_WINDOW_S", "WGS84_A", "WGS84_B", "WGS84_E2"):
        assert getattr(constants, name) == getattr(jconstants, name), name
    assert datamodel.utc_now_iso()[:4].isdigit() and datamodel.utc_now_iso().endswith("+00:00")


def test_geo_matches_reference_in_float64():
    rng = np.random.default_rng(3)
    enu = rng.uniform(-30_000, 30_000, size=(5, 3))
    enu[:, 2] = rng.uniform(-50, 400, size=5)
    lat0, lng0 = 35.47, -97.51
    with enable_x64():
        ref = [np.asarray(v) for v in jgeo.enu_to_lat_lng(enu, lat0, lng0, 12.0)]
        ref_ecef = [np.asarray(v) for v in jgeo.lat_lng_to_ecef_wgs84(ref[0], ref[1], ref[2])]
        ref_rot = np.asarray(jgeo.enu_rotation(lat0, lng0))
    ours = geo.enu_to_lat_lng(enu, lat0, lng0, 12.0)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-9, rtol=0)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-9, rtol=0)
    np.testing.assert_allclose(ours[2], ref[2], atol=1e-6, rtol=0)
    for a, b in zip(geo.lat_lng_to_ecef_wgs84(ref[0], ref[1], ref[2]), ref_ecef):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    np.testing.assert_allclose(geo.enu_rotation(lat0, lng0), ref_rot, atol=1e-15)
    # the round trip through the forward transform
    back = np.stack([geo.lat_lng_to_enu_np(la, lo, al, lat0, lng0, 12.0) for la, lo, al in zip(*ours)])
    np.testing.assert_allclose(back, enu, atol=1e-6)
