"""The demodulators: the port's ``ops/demod`` vs the JAX package's on the
same numpy inputs (batch ``[3, 8192]``, state carried over two blocks),
and the reference's own scenes from ``tests/test_demod.py`` run through
both packages.

Tolerances and why (``scale`` is the largest |input| of the call):

- ``fm_demod``: within 1e-5 rad, wrap-aware (``angle(exp(i·(a − b)))``):
  both take atan2 of the same complex64 product, and at ±π the sign may
  flip between backends;
- ``deemphasis``: within 1e-5 of ``scale`` against ``lax.scan``, over two
  blocks with the state carried, and on a row long enough for three
  levels of the blocked recurrence; the final state likewise;
- ``fir_decimate``, ``channelize_watch``, ``usb``/``lsb``/``am``,
  ``resample_pow2`` (8192 → 4096), the FM pipelines and
  ``watch_demod_block`` in all five modes: within 1e-5 of the reference's
  largest |output| (float32 products summed in another order; the
  oscillators are the same complex64 numpy tables); squelch masks and
  decimation exactly equal in shape and open flags.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu.ops import demod as jdemod

from radio_mapper_tpu_torch.ops import demod
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

FS = 256_000.0
N = 8192
REL = 1e-5


def _fm(n, fs, msg_hz, dev_hz, phase0=0.0):
    t = np.arange(n) / fs
    msg = np.sin(2 * np.pi * msg_hz * t)
    return np.exp(1j * (phase0 + 2 * np.pi * dev_hz * np.cumsum(msg) / fs))


def _batch(seed=0, n=2 * N):
    """``[3, n]`` complex64: two FM rows (tone messages) and a noisy AM row."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    rows = [
        _fm(n, FS, 700.0, 4000.0) + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n)),
        0.5 * _fm(n, FS, 1900.0, 12_000.0, phase0=1.0),
        (1.0 + 0.4 * np.sin(2 * np.pi * 900.0 * t)) * np.exp(2j * np.pi * 3000.0 * t)
        + 0.05 * (rng.normal(size=n) + 1j * rng.normal(size=n)),
    ]
    return np.stack(rows).astype(np.complex64)


def _close(ours, ref, rel=REL, scale=None):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    scale = float(np.abs(ref).max()) if scale is None else scale
    err = float(np.abs(ours - ref).max()) if ref.size else 0.0
    assert err <= rel * max(scale, 1e-30), (err, scale)
    return err


def _wrap_close(ours, ref, tol=1e-5):
    d = np.angle(np.exp(1j * (ours.numpy().astype(np.float64) - np.asarray(ref, np.float64))))
    assert np.abs(d).max() <= tol


def test_fm_demod_two_blocks_with_prev():
    x = _batch()
    a, b = x[:, :N], x[:, N:]
    _wrap_close(demod.fm_demod(torch.from_numpy(a), gain=0.5), jdemod.fm_demod(jnp.asarray(a), gain=0.5))
    prev = a[:, -1:]
    ours = demod.fm_demod(torch.from_numpy(b), prev=torch.from_numpy(prev))
    ref = jdemod.fm_demod(jnp.asarray(b), prev=jnp.asarray(prev))
    _wrap_close(ours, ref)


@pytest.mark.parametrize("fn", ["am", "usb", "lsb", "dc_block", "decimate"])
def test_simple_demods(fn):
    x = _batch(1)[:, :N]
    if fn == "am":
        _close(demod.am_demod(torch.from_numpy(x)), jdemod.am_demod(jnp.asarray(x)))
    elif fn in ("usb", "lsb"):
        kw = dict(sample_rate_hz=FS, bfo_hz=1700.0)
        ours = getattr(demod, f"{fn}_demod")(torch.from_numpy(x), **kw)
        ref = getattr(jdemod, f"{fn}_demod")(jnp.asarray(x), **kw)
        _close(ours, ref)
    elif fn == "dc_block":
        _close(demod.dc_block(torch.from_numpy(x.real.copy())), jdemod.dc_block(jnp.asarray(x.real)))
    else:
        xr = x.real[:, : N - 3].copy()  # a remainder the decimator drops
        _close(demod.decimate(torch.from_numpy(xr), 7), jdemod.decimate(jnp.asarray(xr), 7))


def test_deemphasis_matches_scan_over_two_carried_blocks():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 2 * N)).astype(np.float32)
    scale = float(np.abs(x).max())
    kw = dict(sample_rate_hz=32_000.0, tau_s=75e-6)
    ya, sa = demod.deemphasis(torch.from_numpy(x[:, :N]), **kw)
    ja, jsa = jdemod.deemphasis(jnp.asarray(x[:, :N]), **kw)
    _close(ya, ja, scale=scale)
    _close(sa, jsa, scale=scale)
    yb, sb = demod.deemphasis(torch.from_numpy(x[:, N:]), init=sa, **kw)
    jb, jsb = jdemod.deemphasis(jnp.asarray(x[:, N:]), init=jsa, **kw)
    _close(yb, jb, scale=scale)
    _close(sb, jsb, scale=scale)


@pytest.mark.parametrize("n,fs", [(70_001, 48_000.0), (5, 32_000.0), (64 * 64, 16_000.0)])
def test_deemphasis_levels(n, fs):
    """Rows of three recursion levels (70001 = 1094 chunks, a ragged end),
    shorter than one chunk, and exactly one chunk of chunks."""
    x = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
    init = np.array([[0.3], [-1.2]], np.float32)
    y, s = demod.deemphasis(torch.from_numpy(x), sample_rate_hz=fs, init=torch.from_numpy(init))
    jy, js = jdemod.deemphasis(jnp.asarray(x), sample_rate_hz=fs, init=jnp.asarray(init))
    scale = float(np.abs(x).max())
    _close(y, jy, scale=scale)
    _close(s, js, scale=scale)


def test_squelch_masks_and_gates():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=(2, N)) * 0.001, rng.normal(size=(1, N))]).astype(np.complex64)
    g, o = demod.squelch(torch.from_numpy(x), 0.01)
    jg, jo = jdemod.squelch(jnp.asarray(x), 0.01)
    assert o.tolist() == np.asarray(jo).tolist() == [False, False, True]
    _close(g, jg)


def test_resample_pow2_8192_to_4096():
    t = np.arange(N) / FS
    x = np.stack([np.sin(2 * np.pi * 1000.0 * t), np.cos(2 * np.pi * 3100.0 * t) * 0.3,
                  np.random.default_rng(4).normal(size=N)]).astype(np.float32)
    _close(demod.resample_pow2(torch.from_numpy(x), 4096), jdemod.resample_pow2(jnp.asarray(x), 4096))


def test_fir_decimate_and_channelize_watch():
    x = _batch(5)[:, :N]
    _close(demod.fir_decimate(torch.from_numpy(x), 4), jdemod.fir_decimate(jnp.asarray(x), 4))
    xr = x.real.copy()
    _close(demod.fir_decimate(torch.from_numpy(xr), 3, taps_per_phase=6, cutoff=0.4),
           jdemod.fir_decimate(jnp.asarray(xr), 3, taps_per_phase=6, cutoff=0.4))
    kw = dict(sample_rate_hz=1_024_000.0, offsets_hz=(200e3, -150e3, 0.0), channel_rate_hz=256_000.0)
    ours = demod.channelize_watch(torch.from_numpy(x), **kw)
    ref = jdemod.channelize_watch(jnp.asarray(x), **kw)
    assert tuple(ours.shape) == (3, 3, N // 4)
    _close(ours, ref)


def test_nbfm_and_wbfm_pipelines():
    x = _batch(6)[:2]  # the FM rows
    for kw in (dict(audio_rate_hz=16_000.0), dict(audio_rate_hz=32_000.0, deemph_tau_s=75e-6)):
        _close(demod.nbfm_pipeline(torch.from_numpy(x), sample_rate_hz=FS, **kw),
               jdemod.nbfm_pipeline(jnp.asarray(x), sample_rate_hz=FS, **kw))
    _close(demod.wbfm_pipeline(torch.from_numpy(x), sample_rate_hz=FS),
           jdemod.wbfm_pipeline(jnp.asarray(x), sample_rate_hz=FS))


def _watch_capture(n=65_536, fs=1_024_000.0):
    """An FM carrier at +200 kHz, an AM carrier at −300 kHz, weak noise."""
    rng = np.random.default_rng(7)
    t = np.arange(n) / fs
    iq = (_fm(n, fs, 800.0, 4000.0) * np.exp(2j * np.pi * 200e3 * t)
          + 0.6 * (1 + 0.5 * np.sin(2 * np.pi * 600.0 * t)) * np.exp(2j * np.pi * -298.5e3 * t)
          + 0.01 * (rng.normal(size=n) + 1j * rng.normal(size=n)))
    return iq.astype(np.complex64)


@pytest.mark.parametrize("mode", ["nbfm", "wbfm", "am", "usb", "lsb"])
@pytest.mark.parametrize("squelch", [0.0, 0.05])
def test_watch_demod_block_modes(mode, squelch):
    iq = _watch_capture()
    kw = dict(sample_rate_hz=1_024_000.0, offsets_hz=(200e3, -300e3, 50e3), mode=mode,
              channel_rate_hz=256_000.0, audio_rate_hz=16_000.0, squelch_threshold=squelch)
    audio, open_ = demod.watch_demod_block(torch.from_numpy(iq), **kw)
    jaudio, jopen = jdemod.watch_demod_block(jnp.asarray(iq), **kw)
    assert open_.tolist() == np.asarray(jopen).tolist()
    if squelch:
        assert open_.tolist() == [True, True, False]
        assert not audio[2].any()
    _close(audio, jaudio)


# --- the reference's scenes (tests/test_demod.py), through both packages -----


def _scene(name):
    """``(port output, reference output, check)`` of one reference scene;
    ``check`` holds the port's output to the scene's own assertion."""
    n = 65_536
    t = np.arange(n) / FS
    if name == "fm_message":
        iq = _fm(n, FS, 1000.0, 5000.0).astype(np.complex64)
        msg = np.sin(2 * np.pi * 1000.0 * t)
        expected = 2 * np.pi * 5000.0 * msg / FS
        check = lambda a: np.corrcoef(a[10:], expected[10:])[0, 1] > 0.999
        return demod.fm_demod(torch.from_numpy(iq)), jdemod.fm_demod(jnp.asarray(iq)), check
    if name == "am":
        msg = 0.5 * np.sin(2 * np.pi * 800.0 * t)
        iq = ((1.0 + msg) * np.exp(2j * np.pi * 3000.0 * t)).astype(np.complex64)
        check = lambda a: np.corrcoef(a, msg)[0, 1] > 0.99
        return demod.am_demod(torch.from_numpy(iq)), jdemod.am_demod(jnp.asarray(iq)), check
    if name == "usb_shift":
        iq = np.exp(2j * np.pi * 2000.0 * t).astype(np.complex64)
        f = np.fft.rfftfreq(n, 1 / FS)
        check = lambda a: abs(f[np.argmax(np.abs(np.fft.rfft(a)))] - 500.0) < 10.0
        kw = dict(sample_rate_hz=FS, bfo_hz=1500.0)
        return demod.usb_demod(torch.from_numpy(iq), **kw), jdemod.usb_demod(jnp.asarray(iq), **kw), check
    if name in ("deemph_lo", "deemph_hi"):
        f0 = 100.0 if name == "deemph_lo" else 15_000.0
        x = np.sin(2 * np.pi * f0 * t).astype(np.float32)
        check = (lambda a: np.std(a) / np.std(x) > 0.9) if f0 < 1000 else (lambda a: np.std(a) / np.std(x) < 0.2)
        return (demod.deemphasis(torch.from_numpy(x), sample_rate_hz=FS)[0],
                jdemod.deemphasis(jnp.asarray(x), sample_rate_hz=FS)[0], check)
    if name == "resample_tone":
        x = np.sin(2 * np.pi * 1000.0 * t[:8192]).astype(np.float32)
        f = np.fft.rfftfreq(4096, 2 / FS)
        check = lambda a: (abs(f[np.argmax(np.abs(np.fft.rfft(a)))] - 1000.0) < 40.0
                           and abs(np.std(a) / np.std(x) - 1) < 0.05)
        return demod.resample_pow2(torch.from_numpy(x), 4096), jdemod.resample_pow2(jnp.asarray(x), 4096), check
    if name == "wbfm_tone":
        iq = _fm(n, FS, 1000.0, 50_000.0).astype(np.complex64)

        def check(a):
            f = np.fft.rfftfreq(a.size, 1 / 32_000.0)
            spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
            return abs(f[np.argmax(spec[5:]) + 5] - 1000.0) < 20.0

        kw = dict(sample_rate_hz=FS, audio_rate_hz=32_000.0)
        return demod.wbfm_pipeline(torch.from_numpy(iq), **kw), jdemod.wbfm_pipeline(jnp.asarray(iq), **kw), check
    if name == "nbfm_tone":
        iq = _fm(n, FS, 400.0, 2500.0).astype(np.complex64)
        ref = np.sin(2 * np.pi * 400.0 * t)[: n - n % 16].reshape(-1, 16).mean(-1)
        check = lambda a: a.shape[-1] == n // 16 and np.corrcoef(a[4:], ref[4:])[0, 1] > 0.99
        kw = dict(sample_rate_hz=FS, audio_rate_hz=16_000.0)
        return demod.nbfm_pipeline(torch.from_numpy(iq), **kw), jdemod.nbfm_pipeline(jnp.asarray(iq), **kw), check
    if name == "nbfm_deemph":
        iq = _fm(n, FS, 6000.0, 2500.0).astype(np.complex64)
        plain = demod.nbfm_pipeline(torch.from_numpy(iq), sample_rate_hz=FS).numpy()
        check = lambda a: np.std(a) < 0.7 * np.std(plain)
        kw = dict(sample_rate_hz=FS, deemph_tau_s=75e-6)
        return demod.nbfm_pipeline(torch.from_numpy(iq), **kw), jdemod.nbfm_pipeline(jnp.asarray(iq), **kw), check
    raise KeyError(name)


@pytest.mark.parametrize("name", ["fm_message", "am", "usb_shift", "deemph_lo", "deemph_hi", "resample_tone",
                                  "wbfm_tone", "nbfm_tone", "nbfm_deemph"])
def test_reference_scenes(name):
    ours, ref, check = _scene(name)
    _close(ours, ref)
    assert check(ours.numpy())


@pytest.mark.parametrize("fn", ["fir_decimate", "deemphasis", "watch_demod_block"])
def test_no_matmul_conv_or_gather(fn):
    """``fir_decimate`` and ``deemphasis`` (and the watch block on top of
    them) run elementwise float32 products and sums only: no matmul or
    convolution (no TF32 path, whatever the global flags say) and no index
    gather. The profiler lists every aten op the call dispatched."""
    x = torch.from_numpy(_batch(8)[:, :N])
    call = {
        "fir_decimate": lambda: demod.fir_decimate(x, 4),
        "deemphasis": lambda: demod.deemphasis(x.real.contiguous(), sample_rate_hz=FS),
        "watch_demod_block": lambda: demod.watch_demod_block(
            x[0], sample_rate_hz=1_024_000.0, offsets_hz=(100e3,), mode="wbfm"),
    }[fn]
    call()  # tables built and cached
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    ops = {e.key for e in prof.key_averages()}
    banned = {"aten::mm", "aten::bmm", "aten::addmm", "aten::matmul", "aten::convolution", "aten::conv1d",
              "aten::index", "aten::gather", "aten::take_along_dim", "aten::einsum"}
    assert not ops & banned, ops & banned
    assert "aten::unfold" in ops or fn == "deemphasis"
