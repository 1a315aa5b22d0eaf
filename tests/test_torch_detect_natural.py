"""Natural-order detection: the port's ``sliding_max``, ``median_bisect``,
``top_k_segmented``, ``detect_peaks`` and ``estimate_bandwidth_hz`` vs the
JAX package with its safe mode forced on (what the TPU runs).

Tolerances and why: every selection (peak bins, validity, tie order,
local-max masks) exactly — integer decisions on identical float32
inputs; the bisected floor within 1e-4 dB (the same float32 steps, so in
practice bit-equal); derived floats within 1e-6 relative (the same
float32 formulas); bandwidths exactly (integer bin counts × one scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu.ops import detect as jdetect
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops import spectral as jspectral

from radio_mapper_tpu_torch.ops import detect, safe, spectral
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

FS = 2_048_000.0


@pytest.fixture(autouse=True)
def safe_mode():
    jsafe.set_safe_mode(True)
    try:
        yield
    finally:
        jsafe.set_safe_mode(None)


def _spectra(rows, f, seed, *, ties=True):
    """dB spectra: noise around −90 dB, tones, exact duplicate peaks inside
    one window and in neighbouring segments, a strong DC bin (notched) and
    a flat row (every bin tied)."""
    rng = np.random.default_rng(seed)
    p = (-90.0 + 3.0 * rng.normal(size=(rows, f))).astype(np.float32)
    for r in range(rows - 1):
        for k in rng.choice(f, size=5, replace=False):
            p[r, k] = np.float32(rng.uniform(-60.0, -20.0))
    p[:, 0] = np.float32(-10.0)  # DC: above threshold, inside the notch
    if ties:
        p[0, 100] = p[0, 104] = np.float32(-15.0)  # tied inside one ±10 window
        p[0, 200] = p[0, 216] = np.float32(-16.0)  # tied 16 bins apart
        p[0, f - 3] = np.float32(-17.0)  # near the edge: the window wraps
        p[0, 5] = np.float32(-17.0)
    p[-1] = np.float32(-50.0)
    return p


@pytest.mark.parametrize("radius", [0, 1, 10, 37, 5000])
def test_sliding_max_matches(radius):
    x = _spectra(4, 1024, radius)
    ours = safe.sliding_max(torch.from_numpy(x), radius)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jsafe.sliding_max(jnp.asarray(x), radius)))
    mask = detect.sliding_local_max(torch.from_numpy(x), radius)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jdetect.sliding_local_max(jnp.asarray(x), radius)))


@pytest.mark.parametrize("f,seed", [(2048, 0), (16384, 1), (1000, 2)])
def test_median_bisect_matches(f, seed):
    x = _spectra(5, f, seed)
    ours = safe.median_bisect(torch.from_numpy(x)).numpy()
    ref = np.asarray(jsafe.median_bisect(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    lower_median = np.sort(x, axis=-1)[:, (f - 1) // 2]  # the bisection's fixed point
    np.testing.assert_allclose(ours, lower_median, atol=1e-3)


@pytest.mark.parametrize("k,segment", [(8, 8), (3, 16)])
def test_top_k_segmented_matches(k, segment):
    rng = np.random.default_rng(k)
    x = rng.exponential(size=(4, 512)).astype(np.float32)
    x[rng.random(size=x.shape) < 0.8] = -np.inf
    x[0, 17] = x[0, 90] = x[0, 300] = np.float32(40.0)  # tied across segments
    x[1, 64] = x[1, 65] = np.float32(40.0)  # tied inside one segment: collapses
    x[2] = -np.inf
    tv, ti = safe.top_k_segmented(torch.from_numpy(x), k, segment)
    jv, ji = jsafe.top_k_segmented(jnp.asarray(x), k, segment)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0, :3].tolist() == [17, 90, 300]
    assert ti[1, :2].tolist() == [64, int(ti[1, 1])] and int(ti[1, 1]) != 65


def _assert_peaks_equal(ours, ref):
    for f in ("bin_index", "valid"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(ours.noise_floor_db.numpy(), np.asarray(ref.noise_floor_db), atol=1e-4, rtol=0)
    for f in ("freq_offset_hz", "power_db", "snr_db", "confidence"):
        np.testing.assert_allclose(
            getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-6, atol=1e-4, err_msg=f
        )


@pytest.mark.parametrize(
    "f,kw",
    [
        (4096, dict()),  # segmented top-K, stride-1 floor
        (16384, dict(noise_floor_stride=8, max_peaks=4)),
        (4096, dict(min_distance_bins=3)),  # flat top-K: radius < 7
        (1000, dict(threshold_db=-40.0)),  # flat top-K: F not a multiple of 8
        (2048, dict(dc_notch_hz=None, confidence_floor=0.0)),  # no notch, no confidence gate
        (2048, dict(confidence_floor=1.5)),  # nothing passes
    ],
)
def test_detect_peaks_matches(f, kw):
    x = _spectra(4, f, f + len(kw))
    ref = jdetect.detect_peaks(jnp.asarray(x), sample_rate_hz=FS, **kw)
    ours = detect.detect_peaks(torch.from_numpy(x), sample_rate_hz=FS, **kw)
    _assert_peaks_equal(ours, ref)
    if kw.get("confidence_floor", 0.3) <= 1.0:
        assert ours.valid[0].any()
    if kw.get("dc_notch_hz", 1.0) is not None:
        assert not (ours.valid & (ours.bin_index == 0)).any()  # the DC bin is notched


@pytest.mark.parametrize("smooth", [1, 9])
def test_estimate_bandwidth_matches(smooth):
    rng = np.random.default_rng(smooth)
    f = 4096
    p = (-90.0 + 2.0 * rng.normal(size=(3, f))).astype(np.float32)
    for r, (c, w) in enumerate([(300, 40), (2000, 5), (f - 10, 30)]):  # the last one wraps
        idx = (c + np.arange(-w, w + 1)) % f
        p[r, idx] = np.float32(-30.0) - np.abs(np.arange(-w, w + 1)).astype(np.float32) * 0.2
    peaks = np.array([[300, 310, 0], [2000, 1999, 5], [f - 10, 1, 4095]], dtype=np.int32)
    kw = dict(smooth_bins=smooth)
    ref = jspectral.estimate_bandwidth_hz(jnp.asarray(p)[..., None, :], jnp.asarray(peaks), FS, **kw)
    ours = spectral.estimate_bandwidth_hz(torch.from_numpy(p).unsqueeze(-2), torch.from_numpy(peaks), FS, **kw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert ours.dtype == torch.float32 and ours.shape == (3, 3)
    for n, sr in ((1000, FS), (16384, 2.4e6)):
        np.testing.assert_array_equal(spectral.fft_frequencies_hz(n, sr), jspectral.fft_frequencies_hz(n, sr))
