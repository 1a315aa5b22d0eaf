"""Channelizer parity: the port's PFB and branch DFT vs the JAX package.

The prototype filter and the DFT table are the same numpy arithmetic,
held bit-identical. ``channelize_split`` is held within 1e-5 of the
output's max |value|: T float32 multiply-adds and an M-point float32
matrix product, rounded in another order. ``pair_select`` is an exact
gather in both packages on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu.ops import channelizer as jpfb
from radio_mapper_tpu.ops import fft as jfft
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops import split_complex as jsc

from radio_mapper_tpu_torch.ops import channelizer, safe, split_complex
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


@pytest.mark.parametrize("m,t", [(16, 8), (8, 8), (4, 3)])
def test_prototype_filter_bit_identical(m, t):
    ours = channelizer.prototype_filter(m, t)
    ref = jpfb.prototype_filter(m, t)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("n", [8, 16, 64])
def test_dft_matrix_bit_identical(n):
    for a, b in zip(fft_ops.dft_matrix(n), jfft._dft_matrix(n)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_dft_direct_matches_numpy_and_rejects_long_rows():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 16)) + 1j * rng.normal(size=(3, 16))
    re, im = fft_ops.dft_direct(torch.from_numpy(x.real.astype(np.float32)),
                                torch.from_numpy(x.imag.astype(np.float32)))
    np.testing.assert_allclose(re.numpy() + 1j * im.numpy(), np.fft.fft(x), atol=1e-5)
    with pytest.raises(ValueError):
        fft_ops.dft_direct(torch.zeros(1, 2048), torch.zeros(1, 2048))


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("b,m,t,frames", [(3, 16, 8, 300), (2, 8, 8, 129)])
def test_channelize_split_matches_jax(shift, b, m, t, frames):
    rng = np.random.default_rng(m + frames)
    n = m * (frames + t - 1)
    re = rng.normal(size=(b, n)).astype(np.float32)
    im = rng.normal(size=(b, n)).astype(np.float32)
    ref = jsc.channelize_split(jnp.asarray(re), jnp.asarray(im), m,
                               sample_rate_hz=10e6, taps_per_channel=t, shift=shift)
    ours = split_complex.channelize_split(torch.from_numpy(re), torch.from_numpy(im), m,
                                          sample_rate_hz=10e6, taps_per_channel=t, shift=shift)
    for o, r in zip(ours, ref):
        r = np.asarray(r)
        assert o.shape == r.shape == (b, m, frames)
        assert np.abs(o.numpy() - r).max() <= 1e-5 * np.abs(r).max()


def test_channelize_split_rejects_bad_lengths():
    with pytest.raises(ValueError):  # not a multiple of M
        split_complex.channelize_split(torch.zeros(2, 100), torch.zeros(2, 100), 16, sample_rate_hz=1.0)
    with pytest.raises(ValueError):  # shorter than the filter
        split_complex.channelize_split(torch.zeros(2, 64), torch.zeros(2, 64), 16, sample_rate_hz=1.0)


@pytest.mark.parametrize("axis", [-1, -2])
def test_pair_select_equals_reference(axis):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 6, 6)).astype(np.float32)
    idx = np.array([0, 5, 2, 2, 4], np.int32)
    ref = np.asarray(jsafe.pair_select(jnp.asarray(x), idx, axis=axis))
    ours = safe.pair_select(torch.from_numpy(x), idx, axis=axis).numpy()
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError):
        safe.pair_select(torch.from_numpy(x), idx, axis=0)
