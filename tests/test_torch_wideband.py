"""The wideband slice: the port's ``WidebandTDOAPipeline`` vs the JAX one.

Both run the small config-4 shape of ``tests/test_wideband.py`` (8 buoys,
4.096 MS/s, 8 subchannels of 1024 samples, max_lag 64 → nfft 2048) on
``synthesize_wideband`` scenes with the emitter in subchannel 3. The JAX
pipeline is built and run under the TPU routing (``_jax_fused_run``: safe
mode, the fused pair stage, in Pallas interpret mode) with its pair-stage
route forced through ``gcc_kernel.set_onehot_pairs`` — "on" is K5, "off"
is the index gather + K6 — and the port is forced onto the same route.

Tolerances and why: lag windows on every subchannel within 1e-4 of each
window's max (the same float32 PFB, transforms and whitening, rounded in
another order); on the active subchannel lags within 1e-3 samples,
weights within 1e-3 (PSR of those windows) and the fix within 0.5 m (the
LM valley is meters wide at this SNR). Quiet subchannels solve noise and
their fixes are not compared.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radio_mapper_tpu import sim as jsim
from radio_mapper_tpu.models import wideband as jwb
from radio_mapper_tpu.ops import split_complex as jsc
from radio_mapper_tpu.ops.pallas import gcc_kernel

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.models import wideband
from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import assert_windows_close, small_wideband_config, wideband_scene
from test_torch_pipeline import _jax_fused_run

cap_cpu_threads()

SUB = 3
_JAX = {}  # route → (pipeline, jitted step, jitted per-subchannel pair stage)


def _jax_config():
    return jwb.WidebandConfig(**dataclasses.asdict(small_wideband_config()))


def _jax_run(route, re, im, anchors):
    """JAX step outputs and ``_pair_stage`` windows of every subchannel,
    traced (once per route) and run under the forced knobs."""

    def run():
        gcc_kernel.set_onehot_pairs(route)
        try:
            if route not in _JAX:
                pipe = jwb.WidebandTDOAPipeline(_jax_config())
                assert pipe._use_fused

                def pair_stages(re, im):
                    c = pipe.config
                    cre, cim = jsc.channelize_split(
                        re, im, c.num_subchannels, sample_rate_hz=c.wide_rate_hz,
                        taps_per_channel=c.taps_per_channel, shift=False,
                    )
                    xs = (jnp.moveaxis(cre, -2, 0), jnp.moveaxis(cim, -2, 0))
                    return jax.lax.map(lambda x: pipe._pair_stage(x[0], x[1]), xs)

                _JAX[route] = (pipe.jit_step_split(), jax.jit(pair_stages))
            step, pair_stages = _JAX[route]
            args = (jnp.asarray(re), jnp.asarray(im))
            return step(*args, jnp.asarray(anchors)), np.asarray(pair_stages(*args))
        finally:
            gcc_kernel.set_onehot_pairs("auto")

    return _jax_fused_run(run)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("route", ["on", "off"])
def test_wideband_matches_jax_on_both_routes(route, seed):
    cfg = small_wideband_config()
    re, im, anchors, emitter = wideband_scene(cfg, SUB, seed)
    ref, ref_mags = _jax_run(route, re, im, anchors)

    pipe = wideband.WidebandTDOAPipeline(cfg, device="cpu")
    t = [torch.from_numpy(a) for a in (re, im, anchors)]
    launches = gcc_pair.onehot_launch_count, gcc_pair.rows_launch_count
    gcc_pair.set_onehot_pairs(route)
    try:
        ours = pipe.step_split(*t)
        cre, cim = wideband.sc_ops.channelize_split(
            t[0], t[1], cfg.num_subchannels, sample_rate_hz=cfg.wide_rate_hz,
            taps_per_channel=cfg.taps_per_channel, shift=False,
        )
        mags = pipe._pair_stage(cre.movedim(-2, 0), cim.movedim(-2, 0)).numpy()
    finally:
        gcc_pair.set_onehot_pairs("auto")
    # the CPU runs the plain versions: no kernel launches
    assert (gcc_pair.onehot_launch_count, gcc_pair.rows_launch_count) == launches

    m, p = cfg.num_subchannels, cfg.num_pairs
    assert mags.shape == ref_mags.shape == (m, p, 2 * cfg.max_lag + 1)
    for k in range(m):
        assert_windows_close(mags[k], ref_mags[k])
    np.testing.assert_allclose(ours.lags[SUB].numpy(), np.asarray(ref.lags)[SUB], atol=1e-3)
    np.testing.assert_allclose(ours.weights[SUB].numpy(), np.asarray(ref.weights)[SUB], atol=1e-3)
    fix = ours.fixes_enu[SUB].numpy()
    np.testing.assert_allclose(fix, np.asarray(ref.fixes_enu)[SUB], atol=0.5)
    np.testing.assert_array_equal(ours.channel_offset_hz, ref.channel_offset_hz)
    assert np.linalg.norm(fix[:2] - emitter[:2]) < 300.0
    w = ours.weights.numpy()
    assert w[SUB].mean() > 3 * w[(SUB + m // 2) % m].mean()


def test_step_outputs_and_stage_hook():
    cfg = small_wideband_config(solver_iterations=3)
    pipe = wideband.WidebandTDOAPipeline(cfg, device="cpu")
    re, im, anchors = pipe.example_inputs(seed=4)
    seen = []
    out = pipe.step_split(re, im, anchors, on_stage=seen.append)
    assert seen == ["channelize", "fft", "s2", "pair", "lag_peaks", "solve"]
    m, p = cfg.num_subchannels, cfg.num_pairs
    assert out.fixes_enu.shape == (m, 3) and out.cost.shape == (m,)
    assert out.lags.shape == out.weights.shape == (m, p)
    assert all(torch.isfinite(x).all() for x in out[:4])
    with pytest.raises(ValueError):  # wrong block length
        pipe.step_split(re[:, :-16], im[:, :-16], anchors)
    with pytest.raises(ValueError):  # not on the pipeline's device
        pipe.step_split(re.to("meta"), im, anchors)


def test_synthesize_wideband_and_example_inputs_bitwise():
    cfg = small_wideband_config()
    jcfg = _jax_config()
    b = cfg.num_buoys
    anchors = np.stack([np.arange(b) * 1e3, np.zeros(b), np.zeros(b)], -1).astype(np.float32)
    kw = dict(active_subchannel=5, anchors_enu=anchors, emitter_enu=np.array([1e3, 2e3, 0.0]),
              snr_db=10.0, seed=9)
    for a, r in zip(sim.synthesize_wideband(cfg, **kw), jsim.synthesize_wideband(jcfg, **kw)):
        np.testing.assert_array_equal(a, r)
    ours = wideband.WidebandTDOAPipeline(cfg, device="cpu").example_inputs(seed=3)
    ref = jwb.WidebandTDOAPipeline(jcfg).example_inputs(seed=3)
    for a, r in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_config_from_dict_validate_and_unported_routes():
    for jcfg in (jwb.WidebandConfig(), _jax_config()):
        ours = wideband.WidebandConfig.from_dict(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(ours) == dataclasses.asdict(jcfg)
        for prop in ("num_pairs", "wide_block", "sub_rate_hz"):
            assert getattr(ours, prop) == getattr(jcfg, prop)
    full = wideband.WidebandConfig()
    assert (full.num_pairs, full.wide_block, full.nfft) == (2016, 65_648, 5120)
    with pytest.raises(ValueError):
        small_wideband_config(max_lag=1024).validate()
    with pytest.raises(ValueError):
        small_wideband_config(num_buoys=1).validate()
    assert wideband.WidebandTDOAPipeline(small_wideband_config(weighting="cc"), device="cpu").use_fused
    # "scot" and "roth" take the natural-grid fallback, as in the reference
    for weighting in ("scot", "roth"):
        pipe = wideband.WidebandTDOAPipeline(small_wideband_config(weighting=weighting), device="cpu")
        assert not pipe.use_fused and pipe.pair_nfft == 1125  # friendly_fft_len(1088)
    with pytest.raises(ValueError):
        small_wideband_config(weighting="gauss").validate()


@pytest.mark.parametrize("variant", ["cc", "l1", "l2"])
@pytest.mark.parametrize("route", ["on", "off"])
def test_wideband_weightings_and_gates_match_jax(route, variant):
    """"cc" (not whitened) and the per-pair PHAT gates l1 and l2 (no gate
    scales) through both pair routes, against the JAX pipeline under the
    same ``set_phat_gate``; the same tolerances as the default route."""
    weighting, gate = ("cc", "l2rx") if variant == "cc" else ("phat", variant)
    cfg = small_wideband_config(weighting=weighting)
    re, im, anchors, emitter = wideband_scene(cfg, SUB, 1)

    def jax_step():
        gcc_kernel.set_onehot_pairs(route)
        gcc_kernel.set_phat_gate(gate)
        try:
            pipe = jwb.WidebandTDOAPipeline(jwb.WidebandConfig(**dataclasses.asdict(cfg)))
            assert pipe._use_fused
            return pipe.jit_step_split()(jnp.asarray(re), jnp.asarray(im), jnp.asarray(anchors))
        finally:
            gcc_kernel.set_onehot_pairs("auto")
            gcc_kernel.set_phat_gate("l2rx")

    ref = _jax_fused_run(jax_step)
    gcc_pair.set_onehot_pairs(route)
    gcc_pair.set_phat_gate(gate)
    try:
        ours = wideband.WidebandTDOAPipeline(cfg, device="cpu").step_split(
            *(torch.from_numpy(a) for a in (re, im, anchors))
        )
    finally:
        gcc_pair.set_onehot_pairs("auto")
        gcc_pair.set_phat_gate("l2rx")
    np.testing.assert_allclose(ours.lags[SUB].numpy(), np.asarray(ref.lags)[SUB], atol=1e-3)
    np.testing.assert_allclose(ours.weights[SUB].numpy(), np.asarray(ref.weights)[SUB], atol=1e-3)
    fix = ours.fixes_enu[SUB].numpy()
    np.testing.assert_allclose(fix, np.asarray(ref.fixes_enu)[SUB], atol=0.5)
    assert np.linalg.norm(fix[:2] - emitter[:2]) < 300.0
