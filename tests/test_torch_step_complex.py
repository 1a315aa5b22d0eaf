"""The complex-IQ step: the port's ``TDOAPipeline.step``/``step_uint8``
vs the JAX package's ``jit_step``/``jit_step_uint8`` (safe mode forced
on, as the TPU runs it: the bisected noise floor, the segmented top-K),
on the same numpy inputs; and the solver's ``solve_tdoa`` name, its
``noise_model="pair"`` covariance and ``pair_weights_from_confidence``.

On the CPU the JAX complex FFT is XLA's native FFT; the port's plain path
is the matmul four-step. Tolerances and why: lags within 1e-3 samples
(float32 rounding of two FFT algorithms moves the parabolic refine by
~1e-5 on these sharp peaks); detections (bins, validity) exactly —
scenes, not noise, so no near-ties; peak power within 1e-3 dB and the
noise floor within 1e-4 dB; pair weights within 1e-3; the fix within
0.5 m (the LM valley is meters wide at these SNRs).
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

from radio_mapper_tpu_torch import sim, solver
from radio_mapper_tpu_torch.models import pipeline
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

CLOSE_BUOYS = (  # a ~2 km square, so the true lags stay inside max_lag 64
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


def _assert_match(ours, ref, fix_m=0.5):
    np.testing.assert_allclose(
        ours.correlation.lag_samples.numpy(), np.asarray(ref.correlation.lag_samples), atol=1e-3
    )
    for f in ("bin_index", "valid"):
        np.testing.assert_array_equal(getattr(ours.peaks, f).numpy(), np.asarray(getattr(ref.peaks, f)), err_msg=f)
    np.testing.assert_allclose(ours.peaks.power_db.numpy(), np.asarray(ref.peaks.power_db), atol=1e-3, rtol=0)
    np.testing.assert_allclose(ours.peaks.noise_floor_db.numpy(), np.asarray(ref.peaks.noise_floor_db), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.pair_weights.numpy(), np.asarray(ref.pair_weights), atol=1e-3)
    np.testing.assert_allclose(ours.fix.position_enu.numpy(), np.asarray(ref.fix.position_enu), atol=fix_m)


def _skill_scene():
    """The library-surface drive's scene: 4 OKC buoys, 16384 samples at
    2.048 MS/s, 150 kHz noise emitter at 25 dB; max_lag 600."""
    cap = sim.synthesize(sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8))
    jcfg = jpipe.PipelineConfig(num_buoys=4, block_len=cap.scenario.block_len,
                                sample_rate_hz=cap.scenario.sample_rate_hz, max_lag=600, power_offset_db=40.0)
    return cap, jcfg


def test_step_matches_jax(safe_mode):
    cap, jcfg = _skill_scene()
    x = cap.iq.astype(np.complex64)
    anchors = cap.buoy_enu.astype(np.float32)
    ref = jpipe.TDOAPipeline(jcfg).jit_step()(jnp.asarray(x), jnp.asarray(anchors))
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    seen = []
    ours = pipeline.TDOAPipeline(cfg, device="cpu").step(
        torch.from_numpy(x), torch.from_numpy(anchors), on_stage=seen.append
    )
    _assert_match(ours, ref)
    assert seen == ["psd", "detect", "spectra", "pair_corr", "lag_peaks", "solve"]
    assert ours.peaks.valid.any() and int(ours.peaks.bin_index.max()) < cfg.block_len
    err = np.linalg.norm(ours.fix.position_enu.numpy()[:2] - cap.emitter_enu[0][:2])
    assert err < 50.0, err


def _quantize(iq, rms_counts=32.0):
    """The dongle's 8-bit frontend: scale, round, clip, interleave."""
    scaled = iq * (rms_counts / np.sqrt(np.mean(np.abs(iq) ** 2)))
    raw = np.empty((*iq.shape[:-1], 2 * iq.shape[-1]), np.uint8)
    raw[..., 0::2] = np.clip(np.round(scaled.real + 127.5), 0, 255).astype(np.uint8)
    raw[..., 1::2] = np.clip(np.round(scaled.imag + 127.5), 0, 255).astype(np.uint8)
    return raw


def test_step_uint8_matches_jax(safe_mode):
    cap, jcfg = _skill_scene()
    jcfg = dataclasses.replace(jcfg, power_offset_db=0.0)
    raw = _quantize(cap.iq)
    anchors = cap.buoy_enu.astype(np.float32)
    ref = jpipe.TDOAPipeline(jcfg).jit_step_uint8()(jnp.asarray(raw), jnp.asarray(anchors))
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    seen = []
    ours = pipeline.TDOAPipeline(cfg, device="cpu").step_uint8(
        torch.from_numpy(raw), torch.from_numpy(anchors), on_stage=seen.append
    )
    _assert_match(ours, ref)
    assert seen[:2] == ["decode", "psd"]
    err = np.linalg.norm(ours.fix.position_enu.numpy()[:2] - cap.emitter_enu[0][:2])
    assert err < 50.0, err


@pytest.mark.parametrize("weighting", ["phat", "scot"])
def test_step_correlation_dwells_matches_jax(safe_mode, weighting):
    """2 channels × 4 buoys × 4 dwells × 4096, max_lag 64, 4 solver starts:
    the dwell-averaged PSD on the 4096 grid and one coherent correlation of
    the 16384-sample capture (nfft friendly_fft_len(16448) = 16875)."""
    dwells, n = 4, 4096
    caps = [
        sim.synthesize(sim.default_scenario(
            buoys=CLOSE_BUOYS, signal="noise", bandwidth_hz=150e3, snr_db=20.0, seed=seed,
            block_len=dwells * n, emitter_lat=35.4700, emitter_lng=-97.5290,
        ))
        for seed in (3, 4)
    ]
    x = np.stack([c.iq for c in caps]).astype(np.complex64)
    anchors = np.stack([c.buoy_enu for c in caps]).astype(np.float32)
    jcfg = jpipe.PipelineConfig(
        num_buoys=4, block_len=n, sample_rate_hz=caps[0].scenario.sample_rate_hz, max_lag=64,
        power_offset_db=40.0, solver_starts=4, correlation_dwells=dwells, weighting=weighting,
    )
    ref = jpipe.TDOAPipeline(jcfg).jit_step()(jnp.asarray(x), jnp.asarray(anchors))
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    pipe = pipeline.TDOAPipeline(cfg, device="cpu")
    ours = pipe.step(torch.from_numpy(x), torch.from_numpy(anchors))
    _assert_match(ours, ref)
    assert int(ours.peaks.bin_index.max()) < n  # detections are on the block_len grid
    if weighting == "phat":
        err = np.linalg.norm(ours.fix.position_enu.numpy()[:, :2] - caps[0].emitter_enu[0][:2], axis=-1)
        assert (err < 50.0).all(), err
    with pytest.raises(ValueError):  # one dwell's worth of samples
        pipe.step(torch.from_numpy(x[..., :n]), torch.from_numpy(anchors))


def test_step_chunking_changes_no_value(monkeypatch):
    """The pair stage in chunks of one channel equals one chunk, bit for bit."""
    cfg = pipeline.PipelineConfig(num_buoys=3, block_len=2048, max_lag=64, solver_iterations=5)
    pipe = pipeline.TDOAPipeline(cfg, device="cpu")
    raw, anchors = pipe.example_inputs(batch=(3,), seed=1, uint8=True)
    whole = pipe.step_uint8(raw, anchors)
    nfft = pipeline.fft_ops.friendly_fft_len(2048 + 64)
    monkeypatch.setattr(pipeline, "PAIR_PLANE_BYTES", 4 * cfg.num_pairs * nfft)
    seen = []
    chunked = pipe.step_uint8(raw, anchors, on_stage=seen.append)
    assert seen.count("pair_corr") == 3
    for a, b in zip(whole.correlation, chunked.correlation):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):  # not complex
        pipe.step(raw.float()[..., :2048], anchors)
    with pytest.raises(ValueError):  # not on the pipeline's device
        pipe.step(torch.zeros(3, 3, 2048, dtype=torch.complex64, device="meta"), anchors)


def _solver_problem(seed=5, batch=(3,)):
    """6 receivers, emitters inside the array, dd with 5 m noise, random weights."""
    rng = np.random.default_rng(seed)
    anchors = rng.uniform(-8000, 8000, size=(*batch, 6, 3)).astype(np.float32)
    anchors[..., 2] = 0.0
    emitter = rng.uniform(-3000, 3000, size=(*batch, 3))
    emitter[..., 2] = 0.0
    pi, pj = jgcc.pair_indices(6)
    d = np.linalg.norm(emitter[..., None, :] - anchors, axis=-1)
    dd = (d[..., pi] - d[..., pj] + rng.normal(scale=5.0, size=(*batch, len(pi)))).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=dd.shape).astype(np.float32)
    return anchors, pi, pj, dd, w, emitter


@pytest.mark.parametrize("noise_model", ["receiver", "pair"])
@pytest.mark.parametrize("solve_2d", [True, False])
def test_solve_tdoa_noise_models_match_jax(noise_model, solve_2d):
    anchors, pi, pj, dd, w, emitter = _solver_problem()
    t = lambda a: torch.from_numpy(np.asarray(a))
    for extra in ({}, {"sigma_floor_m": 20.0}, {"sigma_m": 3.0}):
        kw = dict(solve_2d=solve_2d, iterations=40, noise_model=noise_model, **extra)
        ref = jsolver.solve_tdoa(anchors, pi, pj, dd, w, **kw)
        ours = solver.solve_tdoa(t(anchors), t(pi), t(pj), t(dd), t(w), **kw)
        np.testing.assert_allclose(ours.position_enu.numpy(), np.asarray(ref.position_enu), atol=0.5)
        for f in ("ellipse_major_m", "ellipse_minor_m"):
            np.testing.assert_allclose(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-3, err_msg=f)
        np.testing.assert_allclose(ours.cov_enu.numpy(), np.asarray(ref.cov_enu), rtol=2e-3,
                                   atol=2e-3 * float(np.abs(np.asarray(ref.cov_enu)).max()))
        np.testing.assert_array_equal(ours.num_measurements.numpy(), np.asarray(ref.num_measurements))
    if solve_2d:
        err = np.linalg.norm(ours.position_enu.numpy()[..., :2] - emitter[..., :2], axis=-1)
        assert (err < 50.0).all(), err
    with pytest.raises(ValueError):
        solver.solve_tdoa(t(anchors), t(pi), t(pj), t(dd), t(w), noise_model="nope")


def test_solve_tdoa_is_the_impl_and_receiver_model_unchanged():
    """``solve_tdoa`` is the port's ``solve_tdoa_impl``; ``noise_model=
    "receiver"`` given explicitly is the default, bit for bit."""
    assert solver.solve_tdoa is solver.solve_tdoa_impl
    anchors, pi, pj, dd, w, _ = _solver_problem(seed=6)
    t = lambda a: torch.from_numpy(np.asarray(a))
    a = solver.solve_tdoa_impl(t(anchors), t(pi), t(pj), t(dd), t(w))
    b = solver.solve_tdoa(t(anchors), t(pi), t(pj), t(dd), t(w), noise_model="receiver")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_pair_weights_from_confidence_matches_jax():
    rng = np.random.default_rng(8)
    ci, cj = rng.uniform(0, 1, size=(2, 5, 6)).astype(np.float32)
    sigma = rng.uniform(0, 3e5, size=6).astype(np.float32)
    t = torch.from_numpy
    for s in (None, sigma):
        ours = solver.pair_weights_from_confidence(t(ci), t(cj), None if s is None else t(s))
        ref = jsolver.pair_weights_from_confidence(jnp.asarray(ci), jnp.asarray(cj), None if s is None else jnp.asarray(s))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
