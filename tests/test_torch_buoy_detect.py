"""The buoy's detection dwell: the port's ``runtime.buoy_detect.detect_dwell``
vs the three JAX calls of ``radio_mapper_tpu/runtime/buoy.py``
(``BuoyNode._detector.fn``) with the JAX safe mode forced on (what the
TPU runs).

Tolerances and why: peaks (bins, validity) and bandwidths exactly —
integer decisions; peak power within 1e-3 dB and the floor within 1e-4
dB (the same float32 spectrum from the same matmul four-step, summed in
another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu import constants as jconstants
from radio_mapper_tpu.ops import detect as jdetect
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops import spectral as jspectral
from radio_mapper_tpu.ops import split_complex as jsc

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.runtime import buoy_detect
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


def _jax_dwell(re, im, *, sample_rate_hz, max_peaks, threshold_db, power_offset_db):
    """``BuoyNode._detector.fn`` as the buoy runs it."""
    power_db = jsc.power_spectrum_db_split(re, im) + power_offset_db
    peaks = jdetect.detect_peaks(
        power_db, sample_rate_hz=sample_rate_hz, max_peaks=max_peaks, threshold_db=threshold_db
    )
    bw = jspectral.estimate_bandwidth_hz(
        power_db[..., None, :], peaks.bin_index, sample_rate_hz, smooth_bins=9
    )
    return peaks, bw


@pytest.mark.parametrize(
    "signal,bw_hz,offset_hz,power_offset_db",
    [("fm", 16e3, 150e3, 40.0), ("bpsk", 50e3, -300e3, 30.0), ("tone", 0.0, 90e3, 40.0)],
)
def test_detect_dwell_matches_jax(signal, bw_hz, offset_hz, power_offset_db):
    n = jconstants.DEFAULT_BLOCK_SAMPLES
    cap = sim.synthesize(sim.default_scenario(
        signal=signal, bandwidth_hz=bw_hz, freq_offset_hz=offset_hz, snr_db=25.0, seed=5,
        block_len=n,
    ))
    re = np.ascontiguousarray(cap.iq.real, dtype=np.float32)  # [4 buoys, 16384]
    im = np.ascontiguousarray(cap.iq.imag, dtype=np.float32)
    kw = dict(sample_rate_hz=cap.scenario.sample_rate_hz, max_peaks=8,
              threshold_db=jconstants.DEFAULT_DETECTION_THRESHOLD_DBM, power_offset_db=power_offset_db)
    jsafe.set_safe_mode(True)
    try:
        ref_peaks, ref_bw = _jax_dwell(jnp.asarray(re), jnp.asarray(im), **kw)
    finally:
        jsafe.set_safe_mode(None)
    peaks, bw = buoy_detect.detect_dwell(torch.from_numpy(re), torch.from_numpy(im), **kw)
    for f in ("bin_index", "valid"):
        np.testing.assert_array_equal(getattr(peaks, f).numpy(), np.asarray(getattr(ref_peaks, f)), err_msg=f)
    np.testing.assert_allclose(peaks.power_db.numpy(), np.asarray(ref_peaks.power_db), atol=1e-3, rtol=0)
    np.testing.assert_allclose(peaks.noise_floor_db.numpy(), np.asarray(ref_peaks.noise_floor_db), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(bw.numpy(), np.asarray(ref_bw))
    assert bw.shape == (4, 8)
    # the emitter is found at its offset on the 16384-point grid
    best = peaks.freq_offset_hz[:, 0].numpy()
    assert peaks.valid[:, 0].all()
    assert np.abs(best - offset_hz).max() < max(bw_hz, 2e3), best
