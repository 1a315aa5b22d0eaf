"""The complex-input ops: the port's ``fft``/``ifft``/``fftshift``,
``decode_uint8_iq``, ``power_spectrum_db``/``detect_signals``, the
window copy and the complex GCC family (``cross_correlate``,
``gcc_phat``, ``gcc_phat_all_pairs``, ``gcc_phat_all_pairs_coherent``)
and the split pairwise GCC (``cross_correlate_split``,
``gcc_phat_split``) vs the JAX package on the same numpy inputs.

On the CPU the JAX complex ``fft`` is XLA's native FFT under the default
backend (the TPU's is the matmul four-step, the port's plain path), so
the two sides differ by float32 rounding of two algorithms. Tolerances
and why: spectra within 1e-4 of the row's max |X| (float32 four-step
against a native FFT, ~1e-6 measured); correlation windows within 1e-4
of the window max; lags within 1e-3 samples (float32 sums in another
order move the parabolic refine by ~1e-5 on a sharp peak); through
``detect_signals`` the peaks (bins, validity) exactly, their power within
1e-3 dB and the noise floor within 1e-4 dB. The scenes are band-limited
noise with clear correlation peaks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu.ops import detect as jdetect
from radio_mapper_tpu.ops import fft as jfft
from radio_mapper_tpu.ops import gcc_phat as jgcc
from radio_mapper_tpu.ops import iq as jiq
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops import spectral as jspectral
from radio_mapper_tpu.ops import split_complex as jsc
from radio_mapper_tpu.ops import windows as jwindows

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.ops import detect, gcc_phat, iq, spectral, split_complex, windows
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

WEIGHTINGS = ["phat", "scot", "roth", "cc"]
FS = 2.4e6


def _delayed(shape, n, max_delay, seed, noise=0.3, band=0.15):
    """Complex64 ``[*shape, n]``: delayed copies (fractional delays up to
    ±max_delay samples) of one band-limited noise source per leading row
    plus independent noise; and the delays ``[*shape]``."""
    rng = np.random.default_rng(seed)
    f = np.fft.fftfreq(n)
    lead = shape[:-1]
    src = np.fft.fft(rng.normal(size=(*lead, n)) + 1j * rng.normal(size=(*lead, n))) * (np.abs(f) < band)
    delays = rng.uniform(-max_delay, max_delay, size=shape)
    x = np.fft.ifft(src[..., None, :] * np.exp(-2j * np.pi * f * delays[..., None]))
    x = x + noise * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    return x.astype(np.complex64), delays


def _window_rel(ours, ref):
    """max over windows of max|ours − ref| / max|ref|."""
    ref = np.asarray(ref)
    d = np.abs(ours.numpy() - ref)
    return float((d.max(-1) / np.abs(ref).max(-1)).max())


@pytest.fixture(params=["auto", "matmul"])
def jax_fft_backend(request):
    """The JAX complex FFT as the CPU runs it (XLA's native FFT) and as the
    TPU does (the matmul four-step)."""
    jfft.set_backend(request.param)
    try:
        yield request.param
    finally:
        jfft.set_backend("auto")


@pytest.mark.parametrize("n", [4096, 5000, 16384, 17280])
def test_fft_ifft_match_jax(jax_fft_backend, n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))).astype(np.complex64)
    ours = fft_ops.fft(torch.from_numpy(x))
    ref = np.asarray(jfft.fft(jnp.asarray(x)))
    assert ours.dtype == torch.complex64 and ours.shape == (3, n)
    row = np.abs(ref).max(-1, keepdims=True)
    assert (np.abs(ours.numpy() - ref) / row).max() <= 1e-4
    back = fft_ops.ifft(ours)
    ref_back = np.asarray(jfft.ifft(jnp.asarray(ref)))
    assert (np.abs(back.numpy() - ref_back) / np.abs(x).max(-1, keepdims=True)).max() <= 1e-4
    assert np.abs(back.numpy() - x).max() <= 1e-4 * np.abs(x).max()


def test_fft_pad_axis_and_shift_match_jax():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(1000, 2)) + 1j * rng.normal(size=(1000, 2))).astype(np.complex64)
    for n in (1200, 800):
        ours = fft_ops.fft(torch.from_numpy(x), n=n, axis=0)
        ref = np.asarray(jfft.fft(jnp.asarray(x), n=n, axis=0))
        assert ours.shape == ref.shape
        assert np.abs(ours.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
        ours_i = fft_ops.ifft(torch.from_numpy(x), n=n, axis=0)
        ref_i = np.asarray(jfft.ifft(jnp.asarray(x), n=n, axis=0))
        assert np.abs(ours_i.numpy() - ref_i).max() <= 1e-4 * np.abs(ref_i).max()
    for m in (7, 8):
        v = torch.arange(3 * m).reshape(3, m)
        np.testing.assert_array_equal(fft_ops.fftshift(v).numpy(), np.asarray(jfft.fftshift(jnp.asarray(v.numpy()))))
        np.testing.assert_array_equal(fft_ops.fftshift(v, axis=0).numpy(), np.fft.fftshift(v.numpy(), axes=0))


def test_decode_uint8_iq_matches_jax():
    raw = np.random.default_rng(1).integers(0, 256, size=(2, 3, 64), dtype=np.uint8)
    for scale in (1.0, jiq.UINT8_SCALE):
        ours = iq.decode_uint8_iq(torch.from_numpy(raw), scale=scale)
        assert ours.dtype == torch.complex64
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jiq.decode_uint8_iq(jnp.asarray(raw), scale=scale)))


def test_windows_copy_equals_reference():
    assert windows.available_windows() == jwindows.available_windows()
    for name in jwindows.available_windows():
        for n in (7, 64, 16384):
            np.testing.assert_array_equal(windows.get_window(name, n), jwindows.get_window(name, n), err_msg=name)
        assert windows.coherent_gain(name, 256) == jwindows.coherent_gain(name, 256)
        assert windows.noise_gain(name, 256) == jwindows.noise_gain(name, 256)
    with pytest.raises(ValueError):
        windows.get_window("nope", 8)


@pytest.mark.parametrize("window,nfft,shift", [(None, None, False), ("hann", None, True), ("blackman_harris", 6000, False)])
def test_power_spectrum_db_matches_jax(window, nfft, shift):
    """dB of the same spectra; bins far below the row's peak (deep nulls)
    are held through the spectrum, not in dB."""
    x, _ = _delayed((2, 4), 4096, 20.0, seed=2)
    ours = spectral.power_spectrum_db(torch.from_numpy(x), window=window, nfft=nfft, shift=shift).numpy()
    ref = np.asarray(jspectral.power_spectrum_db(jnp.asarray(x), window=window, nfft=nfft, shift=shift))
    assert ours.shape == ref.shape
    strong = ref > ref.max(-1, keepdims=True) - 40.0
    assert np.abs(ours - ref)[strong].max() <= 1e-3
    lin, rlin = 10.0 ** (ours / 20.0), 10.0 ** (ref / 20.0)
    assert (np.abs(lin - rlin) / rlin.max(-1, keepdims=True)).max() <= 1e-4


@pytest.mark.parametrize(
    "signal,bw_hz,offset_hz",
    [("fm", 16e3, 150e3), ("bpsk", 50e3, -300e3), ("noise", 150e3, 0.0)],
)
def test_detect_signals_matches_jax(signal, bw_hz, offset_hz):
    cap = sim.synthesize(sim.default_scenario(
        signal=signal, bandwidth_hz=bw_hz, freq_offset_hz=offset_hz, snr_db=25.0, seed=5, block_len=16384,
    ))
    x = cap.iq.astype(np.complex64)
    kw = dict(sample_rate_hz=cap.scenario.sample_rate_hz, max_peaks=8, power_offset_db=40.0, noise_floor_stride=8)
    jsafe.set_safe_mode(True)
    try:
        ref = jdetect.detect_signals(jnp.asarray(x), **kw)
    finally:
        jsafe.set_safe_mode(None)
    ours = detect.detect_signals(torch.from_numpy(x), **kw)
    for f in ("bin_index", "valid"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(ours.power_db.numpy(), np.asarray(ref.power_db), atol=1e-3, rtol=0)
    np.testing.assert_allclose(ours.noise_floor_db.numpy(), np.asarray(ref.noise_floor_db), atol=1e-4, rtol=0)
    assert ours.valid.any()


@pytest.mark.parametrize("weighting", WEIGHTINGS)
def test_cross_correlate_and_gcc_phat_match_jax(weighting):
    """Pairwise GCC of [3, 4096] x against y, each delayed by up to ±25
    samples (nfft friendly_fft_len(4096 + 64) = 4320)."""
    xy, delays = _delayed((3, 2), 4096, 25.0, seed=11)
    x, y = xy[:, 0], xy[:, 1]
    kw = dict(max_lag=64, weighting=weighting)
    ours = gcc_phat.cross_correlate(torch.from_numpy(x), torch.from_numpy(y), **kw)
    ref = jgcc.cross_correlate(jnp.asarray(x), jnp.asarray(y), **kw)
    assert ours.shape == (3, 129) and ours.dtype == torch.complex64
    assert _window_rel(ours, ref) <= 1e-4
    peak = gcc_phat.gcc_phat(torch.from_numpy(x), torch.from_numpy(y), sample_rate_hz=FS, **kw)
    rpeak = jgcc.gcc_phat(jnp.asarray(x), jnp.asarray(y), sample_rate_hz=FS, **kw)
    np.testing.assert_allclose(peak.lag_samples.numpy(), np.asarray(rpeak.lag_samples), atol=1e-3)
    np.testing.assert_allclose(peak.tau_s.numpy(), np.asarray(rpeak.tau_s), atol=1e-3 / FS)
    np.testing.assert_allclose(peak.psr.numpy(), np.asarray(rpeak.psr), rtol=1e-4)
    np.testing.assert_allclose(peak.lag_samples.numpy(), delays[:, 0] - delays[:, 1], atol=0.25)


@pytest.mark.parametrize("weighting", WEIGHTINGS)
def test_gcc_phat_all_pairs_matches_jax(weighting):
    """[2 channels, 4 buoys, 8192] → 6 pairs, nfft friendly_fft_len(8192 + 100) = 8640."""
    x, delays = _delayed((2, 4), 8192, 45.0, seed=12)
    kw = dict(sample_rate_hz=FS, max_lag=100, weighting=weighting)
    ours = gcc_phat.gcc_phat_all_pairs(torch.from_numpy(x), **kw)
    ref = jgcc.gcc_phat_all_pairs(jnp.asarray(x), **kw)
    np.testing.assert_allclose(ours.lag_samples.numpy(), np.asarray(ref.lag_samples), atol=1e-3)
    np.testing.assert_allclose(ours.peak_value.numpy(), np.asarray(ref.peak_value), rtol=1e-4)
    np.testing.assert_allclose(ours.psr.numpy(), np.asarray(ref.psr), rtol=1e-4)
    pi, pj = gcc_phat.pair_indices(4)
    np.testing.assert_allclose(ours.lag_samples.numpy(), delays[:, pi] - delays[:, pj], atol=0.25)
    # the window the peaks come from, against the pairwise reference
    fr, fi, nfft = gcc_phat.receiver_spectra(torch.from_numpy(x), max_lag=100)
    assert nfft == jfft.friendly_fft_len(8292) == fr.shape[-1] == fi.shape[-1]
    ti, tj = gcc_phat.pair_index_tensors(4, fr.device)
    mags = gcc_phat.pair_lag_mags(fr, fi, ti, tj, max_lag=100, weighting=weighting)
    ref_win = np.abs(np.asarray(jgcc.cross_correlate(
        jnp.asarray(x[:, pi]), jnp.asarray(x[:, pj]), max_lag=100, weighting=weighting)))
    assert _window_rel(mags, ref_win) <= 1e-4


@pytest.mark.parametrize("weighting", WEIGHTINGS)
@pytest.mark.parametrize("num_blocks", [1, 4])
def test_gcc_phat_all_pairs_coherent_matches_jax(weighting, num_blocks):
    """4 buoys × K dwells × 4096 of one stationary source, K ∈ {1, 4}."""
    x, delays = _delayed((1, 4), 4 * 4096, 25.0, seed=13, noise=0.6)
    x = x[0]
    kw = dict(sample_rate_hz=FS, max_lag=64, num_blocks=num_blocks, weighting=weighting)
    sig = x[..., : num_blocks * 4096]
    ours = gcc_phat.gcc_phat_all_pairs_coherent(torch.from_numpy(np.ascontiguousarray(sig)), **kw)
    ref = jgcc.gcc_phat_all_pairs_coherent(jnp.asarray(sig), **kw)
    np.testing.assert_allclose(ours.lag_samples.numpy(), np.asarray(ref.lag_samples), atol=1e-3)
    np.testing.assert_allclose(ours.psr.numpy(), np.asarray(ref.psr), rtol=1e-4)
    pi, pj = gcc_phat.pair_indices(4)
    np.testing.assert_allclose(ours.lag_samples.numpy(), delays[0, pi] - delays[0, pj], atol=0.25)
    with pytest.raises(ValueError):
        gcc_phat.gcc_phat_all_pairs_coherent(torch.from_numpy(x[..., :4095]), **kw | {"num_blocks": 4})


@pytest.mark.parametrize("weighting", WEIGHTINGS)
def test_split_pairwise_gcc_matches_jax(weighting):
    xy, delays = _delayed((3, 2), 4096, 25.0, seed=14)
    parts = [np.ascontiguousarray(p, dtype=np.float32) for z in (xy[:, 0], xy[:, 1]) for p in (z.real, z.imag)]
    kw = dict(max_lag=64, weighting=weighting)
    cre, cim = split_complex.cross_correlate_split(*(torch.from_numpy(p) for p in parts), **kw)
    rre, rim = jsc.cross_correlate_split(*(jnp.asarray(p) for p in parts), **kw)
    ref = np.asarray(rre) + 1j * np.asarray(rim)
    assert _window_rel(torch.complex(cre, cim), ref) <= 1e-4
    peak = split_complex.gcc_phat_split(*(torch.from_numpy(p) for p in parts), sample_rate_hz=FS, **kw)
    rpeak = jsc.gcc_phat_split(*(jnp.asarray(p) for p in parts), sample_rate_hz=FS, **kw)
    assert isinstance(peak, split_complex.CorrelationPeakSC)
    assert peak._fields == rpeak._fields
    np.testing.assert_allclose(peak.lag_samples.numpy(), np.asarray(rpeak.lag_samples), atol=1e-3)
    np.testing.assert_allclose(peak.psr.numpy(), np.asarray(rpeak.psr), rtol=1e-4)
    np.testing.assert_allclose(peak.lag_samples.numpy(), delays[:, 0] - delays[:, 1], atol=0.25)
    # the split path and the complex path agree
    cplx = gcc_phat.gcc_phat(torch.from_numpy(xy[:, 0]), torch.from_numpy(xy[:, 1]), sample_rate_hz=FS, **kw)
    np.testing.assert_allclose(peak.lag_samples.numpy(), cplx.lag_samples.numpy(), atol=1e-3)


def test_next_pow2_and_errors():
    for n in (1, 2, 3, 1000, 1024, 1025):
        assert gcc_phat.next_pow2(n) == jgcc.next_pow2(n)
    assert gcc_phat.WEIGHTINGS == jgcc.WEIGHTINGS
    x = torch.zeros(2, 100, dtype=torch.complex64)
    with pytest.raises(ValueError):
        gcc_phat.cross_correlate(x, x, max_lag=100)
    with pytest.raises(ValueError):
        gcc_phat.cross_correlate(x, x, max_lag=10, weighting="nope")
