"""The port's numpy float64 helpers vs the JAX package's: the GCC-PHAT
golden model (``ops.gcc_phat.gcc_phat_numpy``), the channelizer's
prototype response (``ops.channelizer.synthesize_tone_response``), a
capture's true pair lag (``sim.Capture.true_pair_lag_samples``) and the
spherical ECEF golden (``geo.lat_lng_to_ecef_sphere_np``).

Both packages run the same float64 numpy arithmetic, so the results are
equal bit for bit.
"""

import numpy as np
import pytest

from radio_mapper_tpu import geo as jgeo
from radio_mapper_tpu import sim as jsim
from radio_mapper_tpu.ops import channelizer as jchannelizer
from radio_mapper_tpu.ops import gcc_phat as jgcc

from radio_mapper_tpu_torch import geo, sim
from radio_mapper_tpu_torch.ops import channelizer, gcc_phat
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


@pytest.mark.parametrize("weighting", ["phat", "scot", "roth", "cc"])
@pytest.mark.parametrize("n, max_lag, x_at, y_at", [(1000, 50, 7, 0), (4096, 300, 0, 123)])
def test_gcc_phat_numpy_matches_jax(weighting, n, max_lag, x_at, y_at):
    """x and y cut from one stream at two offsets, x with its own noise."""
    rng = np.random.default_rng(n)
    s = rng.normal(size=n + 200) + 1j * rng.normal(size=n + 200)
    x = s[x_at: x_at + n] + 0.1 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    y = s[y_at: y_at + n]
    kw = dict(sample_rate_hz=2.4e6, max_lag=max_lag, weighting=weighting, eps=0.05)
    ours = gcc_phat.gcc_phat_numpy(x, y, **kw)
    ref = jgcc.gcc_phat_numpy(x, y, **kw)
    assert ours == ref
    assert abs(ours[1] * 2.4e6 - ours[0]) < 1e-9


def test_gcc_phat_numpy_rejects_an_unknown_weighting():
    x = np.ones(64, np.complex128)
    with pytest.raises(ValueError, match="unknown weighting"):
        gcc_phat.gcc_phat_numpy(x, x, sample_rate_hz=1.0, max_lag=4, weighting="hann")


@pytest.mark.parametrize("num_channels, taps, points", [(16, 8, 512), (8, 6, 100), (64, 4, 33)])
def test_synthesize_tone_response_matches_jax(num_channels, taps, points):
    ours = channelizer.synthesize_tone_response(num_channels, taps, points)
    ref = jchannelizer.synthesize_tone_response(num_channels, taps, points)
    assert ours.shape == (points,)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("seed", [0, 5])
def test_true_pair_lag_samples_matches_jax(seed):
    kw = dict(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=seed)
    cap = sim.synthesize(sim.default_scenario(**kw))
    ref = jsim.synthesize(jsim.default_scenario(**kw))
    b = cap.iq.shape[0]
    for i in range(b):
        for j in range(b):
            lag = cap.true_pair_lag_samples(i, j)
            assert lag == ref.true_pair_lag_samples(i, j)
            assert lag == pytest.approx(-cap.true_pair_lag_samples(j, i), abs=1e-9)


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
def test_lat_lng_to_ecef_sphere_np_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    lat = rng.uniform(-89.0, 89.0, shape)
    lng = rng.uniform(-180.0, 180.0, shape)
    alt = rng.uniform(-50.0, 3000.0, shape)
    ours = geo.lat_lng_to_ecef_sphere_np(lat, lng, alt)
    ref = jgeo.lat_lng_to_ecef_sphere_np(lat, lng, alt)
    for a, r in zip(ours, ref):
        assert np.shape(a) == shape
        np.testing.assert_array_equal(a, r)
    # the torch spherical model in float64 agrees with its golden
    import torch

    t = geo.lat_lng_to_ecef_sphere(*(torch.as_tensor(v, dtype=torch.float64) for v in (lat, lng, alt)))
    for a, r in zip(t, ours):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-12, atol=1e-6)
