"""The power scan (rtl_power parity): the port's ``tools/power_scan`` vs
the JAX package's on the same ``SimulatedSource`` scene, the tone scene
of ``cli.py scan --source sim``.

``plan_scan`` fields equal. ``run_scan`` over the same scene (one hop on
the emitter's channel, the others noise): ``power_db`` within 1e-3 dB on
every kept bin (float32 Welch spectra: the reference's XLA FFT against
the port's matmul four-step, averaged over the frames), ``peak_hold``
likewise, and the CSV rows equal apart from their timestamps (values
printed to 0.01 dB; a value within 1e-3 dB of a rounding edge may
print one step apart, so the printed numbers are held within 0.01).
"""

import dataclasses

import numpy as np
import pytest

from radio_mapper_tpu import sim as jsim
from radio_mapper_tpu.ingest import SimulatedSource as JSimulatedSource
from radio_mapper_tpu.tools import power_scan as jscan

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.ingest import SimulatedSource
from radio_mapper_tpu_torch.tools import power_scan
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


@pytest.mark.parametrize("lo,hi,kw", [
    (88e6, 108e6, dict()),
    (120.5e6, 122.5e6, dict(bin_hz=125.0)),
    (99e6, 102e6, dict(bin_hz=20e3, sample_rate_hz=2.4e6, crop=0.3)),
])
def test_plan_scan_fields(lo, hi, kw):
    ours, ref = power_scan.plan_scan(lo, hi, **kw), jscan.plan_scan(lo, hi, **kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert power_scan.MAX_BINS == jscan.MAX_BINS and power_scan.MAX_HOPS == jscan.MAX_HOPS
    for bad in ((100e6, 90e6), (0.0, 10e9)):
        with pytest.raises(ValueError):
            power_scan.plan_scan(*bad, bin_hz=1000.0, sample_rate_hz=2e6)


def _sources():
    return (SimulatedSource(sim.default_scenario(signal="tone"), 0),
            JSimulatedSource(jsim.default_scenario(signal="tone"), 0))


def _values(line):
    return [float(v) for v in line.split(", ")[6:]]


@pytest.mark.parametrize("bin_hz,peak", [(10_000.0, False), (10_000.0, True), (125.0, False)])
def test_run_scan_tone_scene(bin_hz, peak):
    ours_src, ref_src = _sources()
    plan = power_scan.plan_scan(120.5e6, 122.5e6, bin_hz=bin_hz, sample_rate_hz=ours_src.sample_rate_hz)
    jplan = jscan.plan_scan(120.5e6, 122.5e6, bin_hz=bin_hz, sample_rate_hz=ref_src.sample_rate_hz)
    ours = power_scan.run_scan(ours_src, plan, integration_s=0.05, peak_hold=peak, device="cpu")
    ref = jscan.run_scan(ref_src, jplan, integration_s=0.05, peak_hold=peak)
    assert ours.samples_per_hop == ref.samples_per_hop
    assert len(ours.power_db) == len(ref.power_db) >= 2
    for a, b in zip(ours.power_db, ref.power_db):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a - b).max() <= 1e-3
    np.testing.assert_array_equal(ours.frequencies_hz(), ref.frequencies_hz())
    # the tone stands out on the emitter's hop
    assert ours.flattened_db().max() - np.median(ours.flattened_db()) > 20.0
    rows, jrows = list(power_scan.csv_rows(ours)), list(jscan.csv_rows(ref))
    assert len(rows) == len(jrows)
    for r, j in zip(rows, jrows):
        assert r.split(", ")[2:6] == j.split(", ")[2:6]
        assert np.abs(np.array(_values(r)) - np.array(_values(j))).max() <= 0.0100001


def test_scan_to_csv_passes_and_file(tmp_path):
    ours_src, ref_src = _sources()
    out = tmp_path / "scan.csv"
    lines = power_scan.scan_to_csv(ours_src, 121.0e6, 122.0e6, out_path=str(out), passes=2,
                                   integration_s=0.02, device="cpu")
    jlines = jscan.scan_to_csv(ref_src, 121.0e6, 122.0e6, passes=2, integration_s=0.02)
    assert len(lines) == len(jlines) == 2
    assert out.read_text().splitlines() == lines
    for r, j in zip(lines, jlines):
        assert np.abs(np.array(_values(r)) - np.array(_values(j))).max() <= 0.0100001
