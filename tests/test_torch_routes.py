"""Every single-dwell route of ``TDOAPipeline.step_split``: the port vs JAX.

The scene is ``test_pipeline_mega_path_localizes``'s
(``tests/test_channel_kernel.py``): ``default_scenario`` noise, 150 kHz,
20 dB, seed 13, 4 buoys × 16384 samples at 2.048 MS/s, max_lag 600
(nfft 17408). Each route is forced in both packages by the same knobs —
the JAX side on its TPU routing (safe mode, fused GCC and fused detect
"on", Pallas in interpret mode) plus the route's own knob or config — and
a fresh pipeline is built under them. Every knob is set in ``try/finally``
and put back to its default. The port's stage marks and the kernel
wrappers it calls, in order, show which route ran.

Tolerances and why: detections (``bin_index``, ``valid``) exactly and the
floor within 1e-3 dB (K1's bounds); lags within 1e-3 samples, as the
default route's test (``test_torch_pipeline.py``): the same float32 chain
summed in another order moves the parabolic refine by up to 2.6e-5 here,
and "cc", which the reference runs at bf16x3 (HIGH) and the port at
float32, by under 1e-4 (ROADMAP "Facts": the budget is 0.1 sample); the
fix within 0.5 m of JAX's and 50 m of the emitter.
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
from radio_mapper_tpu.ops.pallas import channel_kernel, gcc_kernel

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.models import pipeline
from radio_mapper_tpu_torch.ops import detect
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops import split_complex as sc
from radio_mapper_tpu_torch.ops.cuda import channel_step, detect_ct, fft_detect, fft_rows, gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

FUSED = (["fft_detect", "peaks", "gcc_pair", "solve"], ["K1", "K2"])
TWO_KERNEL = (["spectra", "detect", "gcc_pair", "solve"], ["K3", "K4", "K2"])
UNFUSED_DETECT = (["spectra", "detect", "gcc_pair", "solve"], ["K3", "K2"])
UNFUSED_GCC = (["spectra", "detect", "pair_corr", "solve"], [])

# route → (config changes, knobs, (the port's stage marks, kernel wrappers called in order))
ROUTES = {
    "mega": ({}, {"mega": "on"}, (["channel_step", "peaks", "lag_peaks", "solve"], ["K8"])),
    "two-kernel": ({}, {"fft_detect": "off"}, TWO_KERNEL),
    "unfused-detect-stride4": ({"noise_floor_stride": 4}, {}, UNFUSED_DETECT),
    "unfused-detect-knob": ({}, {"detect": "off"}, UNFUSED_DETECT),
    "unfused-gcc-scot": ({"weighting": "scot"}, {}, UNFUSED_GCC),
    "unfused-gcc-knob": ({}, {"gcc": "off"}, UNFUSED_GCC),
    "cc": ({"weighting": "cc"}, {}, FUSED),
    "gate-l1": ({}, {"gate": "l1"}, FUSED),
    "gate-l2": ({}, {"gate": "l2"}, FUSED),
}

# kernel → (module, wrapper): the port's kernel wrappers on the single-dwell routes
WRAPPERS = {
    "K1": (fft_detect, "fft_detect_rows_ct"),
    "K2": (gcc_pair, "gcc_pair_lag_mags"),
    "K3": (fft_rows, "fft_rows_ct"),
    "K4": (detect_ct, "detect_ct_partials"),
    "K8": (channel_step, "channel_step_partials"),
}


def _spy_wrappers(monkeypatch):
    """Record, in order, which kernel wrappers the port calls."""
    called = []
    for name, (mod, attr) in WRAPPERS.items():
        def spy(*args, _fn=getattr(mod, attr), _name=name, **kw):
            called.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, attr, spy)
    return called

# knob → (JAX setter, port setter, default)
KNOBS = {
    "mega": (channel_kernel.set_mega_fused, channel_step.set_mega_fused, "off"),
    "fft_detect": (jdetect.set_fused_fft_detect, detect.set_fused_fft_detect, "auto"),
    "detect": (jdetect.set_fused_detect, detect.set_fused_detect, "auto"),
    "gcc": (jsc.set_gcc_fused, sc.set_gcc_fused, "auto"),
    "gate": (gcc_kernel.set_phat_gate, gcc_pair.set_phat_gate, "l2rx"),
}


def _forced(knobs, side, fn):
    """Run ``fn()`` under ``knobs`` on one side (0: JAX on its TPU routing,
    1: the port), restoring every default after."""
    base = {"gcc": "on", "detect": "on"} if side == 0 else {}
    if side == 0:
        jsafe.set_safe_mode(True)
    try:
        for name, mode in {**base, **knobs}.items():
            KNOBS[name][side](mode)
        return fn()
    finally:
        for setters in KNOBS.values():
            setters[side](setters[2])
        if side == 0:
            jsafe.set_safe_mode(None)


@pytest.fixture(scope="module")
def scene():
    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=20.0, seed=13)
    cap = sim.synthesize(scen)
    arrays = [np.real(cap.iq).astype(np.float32), np.imag(cap.iq).astype(np.float32),
              np.asarray(cap.buoy_enu, np.float32)]
    jcfg = jpipe.PipelineConfig(
        num_buoys=arrays[0].shape[0], block_len=arrays[0].shape[-1],
        sample_rate_hz=scen.sample_rate_hz, max_lag=600, power_offset_db=40.0, solver_iterations=20,
    )
    return cap, arrays, jcfg


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_jax(scene, route, monkeypatch):
    cap, arrays, jcfg = scene
    changes, knobs, (marks, kernels) = ROUTES[route]
    jcfg = dataclasses.replace(jcfg, **changes)
    ref = _forced(knobs, 0, lambda: jpipe.TDOAPipeline(jcfg).step_split(*map(jnp.asarray, arrays)))
    seen = []
    called = _spy_wrappers(monkeypatch)
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    ours = _forced(knobs, 1, lambda: pipeline.TDOAPipeline(cfg, device="cpu").step_split(
        *map(torch.from_numpy, arrays), on_stage=seen.append
    ))
    assert seen == marks
    assert called == kernels
    assert ours.peaks.valid.any()
    np.testing.assert_array_equal(ours.peaks.valid.numpy(), np.asarray(ref.peaks.valid))
    np.testing.assert_array_equal(ours.peaks.bin_index.numpy(), np.asarray(ref.peaks.bin_index))
    np.testing.assert_allclose(ours.peaks.noise_floor_db.numpy(), np.asarray(ref.peaks.noise_floor_db), atol=1e-3)
    np.testing.assert_allclose(
        ours.correlation.lag_samples.numpy(), np.asarray(ref.correlation.lag_samples), atol=1e-3
    )
    pos = ours.fix.position_enu.numpy()
    np.testing.assert_allclose(pos, np.asarray(ref.fix.position_enu), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 50.0


def test_routes_agree_where_the_reference_says_they_must(scene):
    """Mega and the default route give the same peaks and lags
    (``test_pipeline_mega_path_localizes``); the two-kernel route's K4
    sees K3's spectra, equal to K1's, so its peaks are the default's too."""
    _cap, arrays, jcfg = scene
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    t = list(map(torch.from_numpy, arrays))
    run = lambda knobs: _forced(knobs, 1, lambda: pipeline.TDOAPipeline(cfg, device="cpu").step_split(*t))
    base, mega, two = run({}), run({"mega": "on"}), run({"fft_detect": "off"})
    for other in (mega, two):
        torch.testing.assert_close(other.peaks.bin_index, base.peaks.bin_index, rtol=0, atol=0)
    torch.testing.assert_close(mega.correlation.lag_samples, base.correlation.lag_samples, rtol=0, atol=0)


def test_unfused_gcc_exact_2n_shortcut():
    """Padding to exactly 2N (block 4096, max_lag 4010: no 5-smooth length
    in [8106, 8192)) makes the detector read the padded spectra's even
    bins, which are the N-point FFT (``pipeline.py:370-379``)."""
    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=20.0, seed=13, block_len=4096)
    cap = sim.synthesize(scen)
    arrays = [np.real(cap.iq).astype(np.float32), np.imag(cap.iq).astype(np.float32),
              np.asarray(cap.buoy_enu, np.float32)]
    jcfg = jpipe.PipelineConfig(num_buoys=4, block_len=4096, sample_rate_hz=scen.sample_rate_hz,
                                max_lag=4010, power_offset_db=40.0, solver_iterations=20, weighting="scot")
    assert fft_ops.friendly_fft_len(4096 + 4010) == 2 * 4096
    ref = _forced({}, 0, lambda: jpipe.TDOAPipeline(jcfg).step_split(*map(jnp.asarray, arrays)))
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    ours = pipeline.TDOAPipeline(cfg, device="cpu").step_split(*map(torch.from_numpy, arrays))
    assert ours.peaks.valid.any()
    np.testing.assert_array_equal(ours.peaks.bin_index.numpy(), np.asarray(ref.peaks.bin_index))
    np.testing.assert_allclose(ours.peaks.noise_floor_db.numpy(), np.asarray(ref.peaks.noise_floor_db), atol=1e-3)
    np.testing.assert_allclose(
        ours.correlation.lag_samples.numpy(), np.asarray(ref.correlation.lag_samples), atol=1e-3
    )
    np.testing.assert_allclose(ours.fix.position_enu.numpy(), np.asarray(ref.fix.position_enu), atol=0.5)
