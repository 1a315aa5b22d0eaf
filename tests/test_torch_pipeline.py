"""The whole slice: the port's ``TDOAPipeline`` vs the JAX pipeline.

The JAX pipeline is forced onto the routing the TPU runs by default —
safe mode, the fused pair stage and the fused FFT + detect kernel, in
Pallas interpret mode on the CPU (the CPU default would take the unfused
XLA route: another gate, another nfft, an exact median). A fresh JAX
pipeline is built under the forced knobs, and they are restored after.

Tolerances and why: ``lag_samples`` within 1e-3 samples (float32 sums in
another order move the parabolic refine by ~1e-5); detections
(``bin_index``, ``valid``) exactly — scenes, not noise, so no ties; the
fix within 0.5 m (the LM valley at these SNRs is meters wide).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu.models import pipeline as jpipe
from radio_mapper_tpu.ops import detect as jdetect
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops import split_complex as jsc

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.models import pipeline

SCENES = {
    "noise-8k": dict(
        scen=dict(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8, block_len=8192),
        cfg=dict(max_lag=256, power_offset_db=40.0),
    ),
    "bpsk-4k": dict(
        scen=dict(signal="bpsk", bandwidth_hz=100e3, snr_db=15.0, seed=7, block_len=4096,
                  freq_offset_hz=60e3, sample_rate_hz=2.4e6),
        cfg=dict(max_lag=128, power_offset_db=30.0, solver_iterations=20),
    ),
}


def _jax_fused_run(fn):
    """Run ``fn()`` with the JAX package forced onto the TPU routing."""
    jsafe.set_safe_mode(True)
    jsc.set_gcc_fused("on")
    jdetect.set_fused_detect("on")
    try:
        return fn()
    finally:
        jdetect.set_fused_detect("auto")
        jsc.set_gcc_fused("auto")
        jsafe.set_safe_mode(None)


def _scene(name):
    spec = SCENES[name]
    cap = sim.synthesize(sim.default_scenario(**spec["scen"]))
    jcfg = jpipe.PipelineConfig(
        num_buoys=cap.iq.shape[0], block_len=cap.iq.shape[1],
        sample_rate_hz=cap.scenario.sample_rate_hz, **spec["cfg"],
    )
    return cap, jcfg


def _assert_outputs_match(ours, ref):
    np.testing.assert_allclose(
        ours.correlation.lag_samples.numpy(), np.asarray(ref.correlation.lag_samples), atol=1e-3
    )
    np.testing.assert_array_equal(ours.peaks.valid.numpy(), np.asarray(ref.peaks.valid))
    np.testing.assert_array_equal(ours.peaks.bin_index.numpy(), np.asarray(ref.peaks.bin_index))
    np.testing.assert_allclose(ours.peaks.noise_floor_db.numpy(), np.asarray(ref.peaks.noise_floor_db), atol=1e-3)
    np.testing.assert_allclose(ours.pair_weights.numpy(), np.asarray(ref.pair_weights), atol=1e-3)
    np.testing.assert_allclose(
        ours.fix.position_enu.numpy(), np.asarray(ref.fix.position_enu), atol=0.5
    )


@pytest.mark.parametrize("name", sorted(SCENES))
def test_step_split_matches_jax_fused_route(name):
    cap, jcfg = _scene(name)
    re = np.real(cap.iq).astype(np.float32)
    im = np.imag(cap.iq).astype(np.float32)
    anchors = cap.buoy_enu.astype(np.float32)
    ref = _jax_fused_run(
        lambda: jpipe.TDOAPipeline(jcfg).step_split(jnp.asarray(re), jnp.asarray(im), jnp.asarray(anchors))
    )
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    ours = pipeline.TDOAPipeline(cfg, device="cpu").step_split(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(anchors)
    )
    _assert_outputs_match(ours, ref)
    assert ours.peaks.valid.any()
    err = np.linalg.norm(ours.fix.position_enu.numpy()[:2] - cap.emitter_enu[0][:2])
    assert err < 50.0, err


def _quantize(iq, rms_counts=32.0):
    """The dongle's 8-bit frontend: scale, round, clip, interleave."""
    scaled = iq * (rms_counts / np.sqrt(np.mean(np.abs(iq) ** 2)))
    raw = np.empty((*iq.shape[:-1], 2 * iq.shape[-1]), np.uint8)
    raw[..., 0::2] = np.clip(np.round(scaled.real + 127.5), 0, 255).astype(np.uint8)
    raw[..., 1::2] = np.clip(np.round(scaled.imag + 127.5), 0, 255).astype(np.uint8)
    return raw


def test_step_split_uint8_matches_jax_fused_route():
    cap, jcfg = _scene("noise-8k")
    jcfg = dataclasses.replace(jcfg, power_offset_db=0.0)
    raw = _quantize(cap.iq)
    anchors = cap.buoy_enu.astype(np.float32)
    ref = _jax_fused_run(
        lambda: jpipe.TDOAPipeline(jcfg).step_split_uint8(jnp.asarray(raw), jnp.asarray(anchors))
    )
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    ours = pipeline.TDOAPipeline(cfg, device="cpu").step_split_uint8(
        torch.from_numpy(raw), torch.from_numpy(anchors)
    )
    _assert_outputs_match(ours, ref)


def _leaves(x):
    return [x] if isinstance(x, torch.Tensor) else [t for f in x for t in _leaves(f)]


def test_scan_equals_single_steps():
    """K blocks through the scan wrapper equal K single steps, bit for bit."""
    cfg = pipeline.PipelineConfig(num_buoys=4, block_len=2048, max_lag=64, solver_iterations=5)
    pipe = pipeline.TDOAPipeline(cfg, device="cpu")
    raw, anchors = pipe.example_inputs(batch=(3, 2), seed=1, uint8=True)
    scan = pipe.step_split_uint8_scan(raw, anchors[0])
    for k in range(3):
        one = pipe.step_split_uint8(raw[k], anchors[0])
        for f_scan, f_one in zip(_leaves(scan), _leaves(one)):
            torch.testing.assert_close(f_scan[k], f_one, rtol=0, atol=0, equal_nan=True)
    re, im, anchors = pipe.example_inputs(batch=(2, 1), seed=2)
    scan = pipe.step_split_scan(re, im, anchors[0])
    assert scan.fix.position_enu.shape == (2, 1, 3)
    assert scan.correlation.lag_samples.shape == (2, 1, cfg.num_pairs)


def test_stage_hook_sees_every_stage():
    cfg = pipeline.PipelineConfig(num_buoys=3, block_len=2048, max_lag=64, solver_iterations=3)
    pipe = pipeline.TDOAPipeline(cfg, device="cpu")
    raw, anchors = pipe.example_inputs(batch=(2,), seed=0, uint8=True)
    seen = []
    pipe.step_split_uint8(raw, anchors, on_stage=seen.append)
    assert seen == ["decode", "pad", "fft_detect", "peaks", "gcc_pair", "lag_peaks", "solve"]


def test_inputs_must_be_on_the_pipeline_device():
    cfg = pipeline.PipelineConfig(num_buoys=3, block_len=2048, max_lag=64)
    pipe = pipeline.TDOAPipeline(cfg, device="cpu")
    re, im, anchors = pipe.example_inputs(seed=0)
    with pytest.raises(ValueError):
        pipe.step_split(re[..., :1024], im[..., :1024], anchors)
    with pytest.raises(ValueError):
        pipe.step_split(re.to("meta"), im, anchors)
