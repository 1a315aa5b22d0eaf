"""Fault F4: the wideband step under the GCC route knob and the weightings
the fused pair stage does not take.

The reference's ``WidebandTDOAPipeline`` takes its fused pair stage only
where ``split_complex.gcc_fused_enabled(sub_block + max_lag, weighting)``
holds; under ``set_gcc_fused("off")``, and for "scot" and "roth", it runs
a natural-grid fallback: spectra at ``friendly_fft_len(sub_block +
max_lag)`` (1125 here), the pair gather, PHAT whitening for "phat" only,
the inverse by conjugation. The port follows the same knob. Both run the
small config-4 shape of ``tests/test_wideband.py`` (8 buoys, 8
subchannels of 1024 samples, max_lag 64) on the ``synthesize_wideband``
scene with the emitter in subchannel 3; the JAX side in safe mode (its
FFT is then the matmul four-step the port's plain path runs) under the
same knob.

Tolerances and why, as ``tests/test_torch_wideband.py`` holds the fused
route: lag windows on every subchannel within 1e-4 of each window's max
(the same float32 transforms and products, rounded in another order); on
the active subchannel lags within 1e-3 samples, weights within 1e-3 and
the fix within 0.5 m. The sharded step at world size 1 against the
one-device step: lags and weights within 1e-5 and the active fix within
1e-2 m, as ``tests/test_torch_wideband_sharded.py`` holds it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radio_mapper_tpu.models import wideband as jwb
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops import split_complex as jsc

from radio_mapper_tpu_torch.models import wideband
from radio_mapper_tpu_torch.ops import split_complex as sc_ops
from radio_mapper_tpu_torch.parallel import jobs, launch
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import assert_windows_close, small_wideband_config, wideband_scene

cap_cpu_threads()

SUB = 3
CASES = {  # name → (route knob, weighting)
    "off-phat": ("off", "phat"),
    "scot": ("auto", "scot"),
    "roth": ("auto", "roth"),
}


def _knob(mode, fn):
    """``fn()`` with both packages' ``set_gcc_fused`` at ``mode``, JAX in
    safe mode; the knobs restored after."""
    prev = sc_ops.gcc_fused_mode()
    jsafe.set_safe_mode(True)
    jsc.set_gcc_fused(mode)
    sc_ops.set_gcc_fused(mode)
    try:
        return fn()
    finally:
        sc_ops.set_gcc_fused(prev)
        jsc.set_gcc_fused("auto")
        jsafe.set_safe_mode(None)


def _jax_run(cfg, re, im, anchors):
    """The JAX step's outputs and every subchannel's ``_pair_stage``."""
    pipe = jwb.WidebandTDOAPipeline(jwb.WidebandConfig(**dataclasses.asdict(cfg)))
    assert not pipe._use_fused

    def pair_stages(re, im):
        c = pipe.config
        cre, cim = jsc.channelize_split(
            re, im, c.num_subchannels, sample_rate_hz=c.wide_rate_hz,
            taps_per_channel=c.taps_per_channel, shift=False,
        )
        xs = (jnp.moveaxis(cre, -2, 0), jnp.moveaxis(cim, -2, 0))
        return jax.lax.map(lambda x: pipe._pair_stage(x[0], x[1]), xs)

    args = (jnp.asarray(re), jnp.asarray(im))
    out = pipe.jit_step_split()(*args, jnp.asarray(anchors))
    return out, np.asarray(jax.jit(pair_stages)(*args))


def _port_run(cfg, re, im, anchors):
    pipe = wideband.WidebandTDOAPipeline(cfg, device="cpu")
    assert not pipe.use_fused and pipe.pair_nfft == 1125
    t = [torch.from_numpy(a) for a in (re, im, anchors)]
    cre, cim = sc_ops.channelize_split(
        t[0], t[1], cfg.num_subchannels, sample_rate_hz=cfg.wide_rate_hz,
        taps_per_channel=cfg.taps_per_channel, shift=False,
    )
    mags = pipe._pair_stage(cre.movedim(-2, 0), cim.movedim(-2, 0))
    return pipe.step_split(*t), mags.numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_wideband_fallback_matches_jax(name):
    mode, weighting = CASES[name]
    cfg = small_wideband_config(weighting=weighting)
    re, im, anchors, emitter = wideband_scene(cfg, SUB, 2)
    ref, ref_mags = _knob(mode, lambda: _jax_run(cfg, re, im, anchors))
    ours, mags = _knob(mode, lambda: _port_run(cfg, re, im, anchors))
    assert mags.shape == ref_mags.shape == (cfg.num_subchannels, cfg.num_pairs, 2 * cfg.max_lag + 1)
    assert_windows_close(mags, ref_mags)  # within 1e-4 of each window max
    np.testing.assert_allclose(ours.lags[SUB].numpy(), np.asarray(ref.lags)[SUB], atol=1e-3)
    np.testing.assert_allclose(ours.weights[SUB].numpy(), np.asarray(ref.weights)[SUB], atol=1e-3)
    np.testing.assert_allclose(ours.fixes_enu[SUB].numpy(), np.asarray(ref.fixes_enu)[SUB], atol=0.5)
    np.testing.assert_array_equal(ours.channel_offset_hz, np.asarray(ref.channel_offset_hz))
    assert np.linalg.norm(ours.fixes_enu[SUB, :2].numpy() - emitter[:2]) < 300.0


def test_fallback_route_follows_the_knob():
    """The route is fixed when the pipeline is built, from the knob and the
    weighting, as the reference's ``_use_fused``."""
    for mode, weighting, fused in (("auto", "phat", True), ("on", "cc", True), ("off", "phat", False),
                                   ("off", "cc", False), ("on", "scot", False), ("auto", "roth", False)):
        cfg = small_wideband_config(weighting=weighting)
        pipe = _knob(mode, lambda: wideband.WidebandTDOAPipeline(cfg, device="cpu"))
        assert pipe.use_fused is fused, (mode, weighting)
        assert pipe.pair_nfft == (cfg.nfft if fused else 1125)
        if mode != "auto":  # off the TPU the reference fuses only when forced "on"
            ref = _knob(mode, lambda: jwb.WidebandTDOAPipeline(jwb.WidebandConfig(**dataclasses.asdict(cfg))))
            assert ref._use_fused is fused, (mode, weighting)


def test_sharded_fallback_equals_step_split():
    """``build_wideband_sharded_step`` at world size 1 under "off" (and for
    "scot") runs the same fallback as the one-device step."""
    cases = [("off", small_wideband_config()), ("auto", small_wideband_config(weighting="scot"))]
    re, im, anchors, _ = wideband_scene(cases[0][1], SUB, 2)
    job = lambda mode, cfg: (jobs.wideband_sharded, dict(config=cfg, re=re, im=im, anchors=anchors, fused=mode))
    outs = launch.run_ranks(jobs.run_jobs, 1, device="cpu", args=([job(*c) for c in cases],), timeout_s=600)[0]
    for (mode, cfg), ours in zip(cases, outs):
        one = _knob(mode, lambda: _port_run(cfg, re, im, anchors))[0]
        np.testing.assert_allclose(ours.lags, one.lags.numpy(), atol=1e-5)
        np.testing.assert_allclose(ours.weights, one.weights.numpy(), atol=1e-5)
        np.testing.assert_allclose(ours.fixes_enu[SUB], one.fixes_enu[SUB].numpy(), atol=1e-2)
