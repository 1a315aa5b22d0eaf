"""The narrowband multi-dwell route (``correlation_dwells > 1``) and the
multi-start solve: the port's ``TDOAPipeline.step_split`` vs the JAX
pipeline with its safe mode forced on (what the TPU runs; on the CPU the
JAX FFT is the same matmul four-step as the port's plain path).

Tolerances and why: ``lag_samples`` within 1e-3 samples (float32 sums in
another order move the parabolic refine by ~1e-4 at these lengths);
detections (``bin_index``, ``valid``) exactly — scenes, not noise, so no
near-ties; the fix within 0.5 m (the LM valley is meters wide at these
SNRs); the reduced ELT scene, whose 5 kHz chirp leaves a valley hundreds
of meters long, within 1 m.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu import solver as jsolver
from radio_mapper_tpu.models import pipeline as jpipe
from radio_mapper_tpu.ops import gcc_phat as jgcc
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops import split_complex as jsc

from radio_mapper_tpu_torch import sim, solver
from radio_mapper_tpu_torch.models import pipeline
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops import split_complex as sc
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

# a compact square (~2 km across) around the OKC network's center, so the
# true lags stay inside max_lag 64 at 2.048 MS/s
CLOSE_BUOYS = (
    ("n", 35.4776, -97.5322, 0.0),
    ("e", 35.4676, -97.5212, 0.0),
    ("s", 35.4576, -97.5322, 0.0),
    ("w", 35.4676, -97.5432, 0.0),
)


@pytest.fixture
def safe_mode():
    jsafe.set_safe_mode(True)
    try:
        yield
    finally:
        jsafe.set_safe_mode(None)


def _as_np(*xs):
    return [np.ascontiguousarray(x, dtype=np.float32) for x in xs]


def _run_both(jcfg, re, im, anchors):
    ref = jpipe.TDOAPipeline(jcfg).step_split(jnp.asarray(re), jnp.asarray(im), jnp.asarray(anchors))
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    ours = pipeline.TDOAPipeline(cfg, device="cpu").step_split(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(anchors)
    )
    return ours, ref


def _assert_match(ours, ref, fix_m=0.5):
    np.testing.assert_allclose(
        ours.correlation.lag_samples.numpy(), np.asarray(ref.correlation.lag_samples), atol=1e-3
    )
    np.testing.assert_array_equal(ours.peaks.valid.numpy(), np.asarray(ref.peaks.valid))
    np.testing.assert_array_equal(ours.peaks.bin_index.numpy(), np.asarray(ref.peaks.bin_index))
    np.testing.assert_allclose(ours.peaks.noise_floor_db.numpy(), np.asarray(ref.peaks.noise_floor_db), atol=1e-3)
    np.testing.assert_allclose(ours.pair_weights.numpy(), np.asarray(ref.pair_weights), atol=1e-3)
    np.testing.assert_allclose(ours.fix.position_enu.numpy(), np.asarray(ref.fix.position_enu), atol=fix_m)


@pytest.mark.parametrize("weighting", ["phat", "cc", "scot", "roth"])
def test_multidwell_step_matches_jax(safe_mode, weighting):
    """2 channels × 4 buoys × 4 dwells × 4096, max_lag 64, 4 solver starts."""
    dwells, n = 4, 4096
    caps = [
        sim.synthesize(sim.default_scenario(
            buoys=CLOSE_BUOYS, signal="noise", bandwidth_hz=150e3, snr_db=20.0, seed=seed,
            block_len=dwells * n, emitter_lat=35.4700, emitter_lng=-97.5290,
        ))
        for seed in (3, 4)
    ]
    re, im, anchors = _as_np(
        np.stack([c.iq.real for c in caps]), np.stack([c.iq.imag for c in caps]),
        np.stack([c.buoy_enu for c in caps]),
    )
    jcfg = jpipe.PipelineConfig(
        num_buoys=4, block_len=n, sample_rate_hz=caps[0].scenario.sample_rate_hz, max_lag=64,
        power_offset_db=40.0, solver_starts=4, correlation_dwells=dwells, weighting=weighting,
    )
    ours, ref = _run_both(jcfg, re, im, anchors)
    _assert_match(ours, ref)
    assert ours.peaks.valid.any()
    assert int(ours.peaks.bin_index.max()) < n  # detections are on the block_len grid
    if weighting == "phat":
        err = np.linalg.norm(ours.fix.position_enu.numpy()[:, :2] - caps[0].emitter_enu[0][:2], axis=-1)
        assert (err < 50.0).all(), err


@pytest.mark.parametrize("weighting", ["phat", "cc", "scot", "roth"])
def test_gcc_phat_all_pairs_split_matches_jax(safe_mode, weighting):
    """The split GCC alone on delayed copies of one band-limited source
    ([2, 5, 3000] → 10 pairs, nfft 3125 = 5⁵, the four-step's 25 × 125)."""
    rng = np.random.default_rng(9)
    n, max_lag = 3000, 100
    f = np.fft.fftfreq(n)
    src = np.fft.fft(rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))) * (np.abs(f) < 0.15)
    delays = rng.uniform(-60, 60, size=(2, 5))
    x = np.fft.ifft(src[:, None, :] * np.exp(-2j * np.pi * f * delays[..., None]))
    x = x + 0.3 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    re, im = _as_np(x.real, x.imag)
    kw = dict(sample_rate_hz=2.048e6, max_lag=max_lag, weighting=weighting)
    ref = jsc.gcc_phat_all_pairs_split(jnp.asarray(re), jnp.asarray(im), **kw)
    ours = sc.gcc_phat_all_pairs_split(torch.from_numpy(re), torch.from_numpy(im), **kw)
    np.testing.assert_allclose(ours.lag_samples.numpy(), np.asarray(ref.lag_samples), atol=1e-3)
    np.testing.assert_allclose(ours.psr.numpy(), np.asarray(ref.psr), rtol=1e-4)
    np.testing.assert_allclose(ours.peak_value.numpy(), np.asarray(ref.peak_value), rtol=1e-4)
    pi, pj = jgcc.pair_indices(5)
    np.testing.assert_allclose(ours.lag_samples.numpy(), delays[:, pi] - delays[:, pj], atol=0.2)


def test_elt_scene_reduced_matches_jax(safe_mode):
    """The 121.5 MHz ELT case of test_validation_scenarios (5 kHz chirp at
    +12 kHz, OKC buoys, 2.048 MS/s, SNR 22 dB, seed 11, max_lag 600, 4
    starts) cut to 4 dwells × 8192."""
    dwells, n = 4, 8192
    scen = sim.Scenario(
        buoys=tuple(sim.Buoy(b, la, ln, al) for b, la, ln, al in sim.OKC_BUOYS),
        emitters=(sim.Emitter(lat=35.46, lng=-97.50, signal="chirp", bandwidth_hz=5e3,
                              freq_offset_hz=12_000.0),),
        center_frequency_mhz=121.5, sample_rate_hz=2_048_000.0, block_len=dwells * n,
        snr_db=22.0, seed=11,
    )
    cap = sim.synthesize(scen)
    re, im, anchors = _as_np(cap.iq.real, cap.iq.imag, cap.buoy_enu)
    jcfg = jpipe.PipelineConfig(
        num_buoys=4, block_len=n, sample_rate_hz=scen.sample_rate_hz, max_lag=600,
        power_offset_db=40.0, solver_starts=4, correlation_dwells=dwells,
    )
    ours, ref = _run_both(jcfg, re, im, anchors)
    _assert_match(ours, ref, fix_m=1.0)
    err = np.linalg.norm(ours.fix.position_enu.numpy()[:2] - cap.emitter_enu[0][:2])
    assert err < 2_000.0, err  # km-scale from 32 ms of a 5 kHz beacon; < 500 m at 8 × 32768


def test_multistart_matches_jax_where_starts_disagree():
    """A compact array (900 m square) and emitters outside and inside it,
    noise-free: from some starts LM runs off into a far valley (tens of
    km), and only the lowest cost over the starts lands on the emitter —
    in both packages."""
    anchors = np.array([[0.0, 0.0, 0.0], [900.0, 0.0, 0.0], [0.0, 900.0, 0.0], [900.0, 900.0, 0.0]],
                       dtype=np.float32)
    emitters = np.array([[-6000.0, 5000.0, 0.0], [7000.0, -4000.0, 0.0], [500.0, 400.0, 0.0]])
    pi, pj = jgcc.pair_indices(4)
    d = np.linalg.norm(emitters[:, None, :] - anchors, axis=-1)
    dd = (d[:, pi] - d[:, pj]).astype(np.float32)
    w = np.random.default_rng(21).uniform(0.5, 1.0, size=dd.shape).astype(np.float32)
    kw = dict(iterations=40)
    ref = jsolver.solve_tdoa_multistart(anchors, pi, pj, dd, w, num_starts=4, **kw)
    t = lambda a: torch.from_numpy(np.asarray(a))
    ours = solver.solve_tdoa_multistart(t(anchors), t(pi), t(pj), t(dd), t(w), num_starts=4, **kw)
    np.testing.assert_allclose(ours.position_enu.numpy(), np.asarray(ref.position_enu), atol=0.5)
    assert (np.linalg.norm(ours.position_enu.numpy() - emitters, axis=-1) < 1.0).all()

    starts = solver.perturbed_starts(t(anchors), 4)
    np.testing.assert_allclose(starts.numpy(), np.asarray(jsolver.perturbed_starts(jnp.asarray(anchors), 4)))
    single = [
        solver.solve_tdoa_impl(t(anchors), t(pi), t(pj), t(dd), t(w), init_enu=s, **kw)
        for s in starts
    ]
    miss = np.stack([np.linalg.norm(s.position_enu.numpy() - emitters, axis=-1) for s in single])
    assert (miss[:, 1:].max(axis=0) > 10_000.0).all(), miss  # some start runs off
    cost = np.stack([s.cost.numpy() for s in single])
    assert (ours.cost.numpy() <= cost.min(axis=0) * (1 + 1e-3) + 1e-6).all()


def test_multidwell_scan_and_stage_hook():
    cfg = pipeline.PipelineConfig(num_buoys=3, block_len=1024, max_lag=64, solver_iterations=3,
                                  correlation_dwells=2, solver_starts=2)
    pipe = pipeline.TDOAPipeline(cfg, device="cpu")
    raw, anchors = pipe.example_inputs(batch=(2, 3), seed=1, uint8=True)
    assert raw.shape == (2, 3, 3, 2 * 2 * 1024)
    seen = []
    pipe.step_split_uint8(raw[0], anchors[0], on_stage=seen.append)
    assert seen == ["decode", "psd", "detect", "spectra", "pair_corr", "lag_peaks", "solve"]
    scan = pipe.step_split_uint8_scan(raw, anchors[0])
    one = pipe.step_split_uint8(raw[1], anchors[0])
    torch.testing.assert_close(scan.fix.position_enu[1], one.fix.position_enu, rtol=0, atol=0)
    assert scan.correlation.lag_samples.shape == (2, 3, cfg.num_pairs)
    re, im, anchors = pipe.example_inputs(seed=2)
    with pytest.raises(ValueError):  # one dwell's worth of samples
        pipe.step_split(re[..., :1024], im[..., :1024], anchors)


def test_multidwell_pair_stage_chunks_change_nothing(monkeypatch):
    cfg = pipeline.PipelineConfig(num_buoys=3, block_len=1024, max_lag=64, solver_iterations=3,
                                  correlation_dwells=2)
    pipe = pipeline.TDOAPipeline(cfg, device="cpu")
    re, im, anchors = pipe.example_inputs(batch=(5,), seed=3)
    whole = pipe.step_split(re, im, anchors)
    seen = []
    nfft = fft_ops.friendly_fft_len(2 * 1024 + 64)
    monkeypatch.setattr(pipeline, "PAIR_PLANE_BYTES", 2 * 4 * cfg.num_pairs * nfft)  # 2 channels a chunk
    chunked = pipe.step_split(re, im, anchors, on_stage=seen.append)
    assert seen.count("pair_corr") == 3
    for a, b in zip(chunked.correlation, whole.correlation):
        torch.testing.assert_close(a, b)  # the same math; a product's blocking may differ by ulps
