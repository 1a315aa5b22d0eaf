"""The leaf spectral ops and the snippet matcher: the port's
``ops/spectral`` (``fft_frequencies_hz(shift=)``,
``absolute_frequencies_hz``, ``frame_signal``, ``welch_psd_db``,
``spectrogram_db``) and ``ops/match`` vs the JAX package's on the same
numpy inputs, JAX in safe mode (its FFT is then the matmul four-step the
port's plain path runs).

Tolerances and why: bin frequencies and frames exactly (the same numpy
arithmetic, the same gather); dB spectra as
``tests/test_torch_gcc_complex.py`` holds ``power_spectrum_db``: within
1e-3 dB on bins within 40 dB of the row's peak and, in linear units,
within 1e-4 of the row's peak everywhere (float32 transforms summed in
another order). Match scores within 1e-5 (ratios of float32 sums of
squares; the scores lie in [0, 1]) and lags exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu.ops import match as jmatch
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops import spectral as jspectral

from radio_mapper_tpu_torch.ops import match, spectral
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


def _iq(shape, seed, tone_bin=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    if tone_bin is not None:  # a strong tone, so the dB rows have a clear peak
        n = shape[-1]
        x = x + 30.0 * np.exp(2j * np.pi * tone_bin * np.arange(n) / 1024)
    return x.astype(np.complex64)


def _safe(fn):
    jsafe.set_safe_mode(True)
    try:
        return np.asarray(fn())
    finally:
        jsafe.set_safe_mode(None)


def _assert_db_close(ours, ref, power):
    """dB spectra: ``power`` 10 or 20 (power or magnitude)."""
    assert ours.shape == ref.shape
    strong = ref > ref.max(-1, keepdims=True) - 40.0
    assert np.abs(ours - ref)[strong].max() <= 1e-3
    lin, rlin = 10.0 ** (ours / power), 10.0 ** (ref / power)
    assert (np.abs(lin - rlin) / rlin.max(-1, keepdims=True)).max() <= 1e-4


@pytest.mark.parametrize("shift", [False, True])
def test_bin_frequencies_equal(shift):
    for n in (8, 1024, 1001):
        np.testing.assert_array_equal(spectral.fft_frequencies_hz(n, 2.4e6, shift=shift),
                                      jspectral.fft_frequencies_hz(n, 2.4e6, shift=shift))
        np.testing.assert_array_equal(spectral.absolute_frequencies_hz(n, 2.4e6, 121.5e6, shift=shift),
                                      jspectral.absolute_frequencies_hz(n, 2.4e6, 121.5e6, shift=shift))


def test_frame_signal_equal():
    x = _iq((2, 3, 5000), 0)
    for frame_len, hop in ((1024, 512), (1000, 333), (5000, 1)):
        ours = spectral.frame_signal(torch.from_numpy(x), frame_len, hop).numpy()
        ref = np.asarray(jspectral.frame_signal(jnp.asarray(x), frame_len, hop))
        np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError):
        spectral.frame_signal(torch.from_numpy(x), 6000, 10)


@pytest.mark.parametrize("reduce,shift,window", [("mean", True, "hann"), ("peak", False, "blackman_harris"),
                                                 ("mean", False, "rectangle")])
def test_welch_psd_db_matches_jax(reduce, shift, window):
    x = _iq((2, 3, 9000), 1, tone_bin=100)
    kw = dict(nfft=1024, overlap=0.5, window=window, shift=shift, reduce=reduce)
    ours = spectral.welch_psd_db(torch.from_numpy(x), **kw).numpy()
    ref = _safe(lambda: jspectral.welch_psd_db(jnp.asarray(x), **kw))
    _assert_db_close(ours, ref, 10.0)
    with pytest.raises(ValueError):
        spectral.welch_psd_db(torch.from_numpy(x), reduce="median")


@pytest.mark.parametrize("nfft,overlap,shift", [(1024, 0.5, True), (256, 0.75, False)])
def test_spectrogram_db_matches_jax(nfft, overlap, shift):
    x = _iq((2, 6000), 2, tone_bin=-200)
    kw = dict(nfft=nfft, overlap=overlap, window="hann", shift=shift)
    ours = spectral.spectrogram_db(torch.from_numpy(x), **kw).numpy()
    ref = _safe(lambda: jspectral.spectrogram_db(jnp.asarray(x), **kw))
    _assert_db_close(ours, ref, 20.0)


def _snippets(seed, m=6, n=256):
    rng = np.random.default_rng(seed)
    q = _iq((n,), seed)
    hist = [np.roll(q, int(rng.integers(-n // 2, n // 2))) * 2.5 * np.exp(1j * rng.uniform(0, 6.28))
            + 0.3 * k * _iq((n,), seed + 100 + k) for k in range(m)]
    return np.stack(hist).astype(np.complex64), q


@pytest.mark.parametrize("seed", [0, 1])
def test_snippet_match_scores_match_jax(seed):
    hist, q = _snippets(seed)
    ours = match.snippet_match_scores(*(torch.from_numpy(np.ascontiguousarray(a)) for a in
                                        (hist.real, hist.imag, q.real, q.imag)))
    ref = _safe(lambda: jmatch.snippet_match_scores(
        jnp.asarray(hist.real), jnp.asarray(hist.imag), jnp.asarray(q.real), jnp.asarray(q.imag))[0])
    ref_lags = _safe(lambda: jmatch.snippet_match_scores(
        jnp.asarray(hist.real), jnp.asarray(hist.imag), jnp.asarray(q.real), jnp.asarray(q.imag))[1])
    np.testing.assert_allclose(ours[0].numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(ours[1].numpy(), ref_lags)
    assert ours[0][0] > 0.999  # the clean copy
    s, lags = match.snippet_match_scores_np(hist, q, device="cpu")
    np.testing.assert_allclose(s, ref, atol=1e-5)
    np.testing.assert_array_equal(lags, ref_lags)
    one, one_lag = match.snippet_match_scores_np(np.roll(q, -9), q, device="cpu")
    assert one.shape == (1,) and one_lag[0] == -9
