"""The single-dwell step at rows past one block's shared memory: the port
vs JAX at block_len 32768.

At block_len 32768 the planner gives nfft 33792 = 128·264 for max_lag 600
(the reference's scenario tests, ``tests/test_validation_scenarios.py``)
and 34816 = 256·136 for max_lag 2048. On the card those rows go to the
long-row designs of kernels K1 and K3 (``csrc/fft_rows_ct_long.cu``, then
K4's column tiles, ``csrc/detect_ct.cu``); on the CPU to the same plain versions as
every other length. Here both packages run ``step_split`` on one channel
× 4 buoys of ``default_scenario`` noise (150 kHz, 20 dB, seed 13), on the
default route (K1 → K2) and the two-kernel route (K3 → K4 → K2), the JAX
side forced onto the same route and its TPU routing as
``tests/test_torch_routes.py`` forces it (Pallas in interpret mode).

Tolerances, those of ``tests/test_torch_routes.py``: detections exactly,
the floor within 1e-3 dB, lags within 1e-3 samples, the fix within 0.5 m
of JAX's and 50 m of the emitter.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radio_mapper_tpu.models import pipeline as jpipe

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.models import pipeline
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_detect, fft_rows
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from test_torch_routes import FUSED, TWO_KERNEL, _forced, _spy_wrappers

cap_cpu_threads()

ROUTES = {"default": ({}, FUSED), "two-kernel": ({"fft_detect": "off"}, TWO_KERNEL)}


@pytest.fixture(scope="module")
def scene():
    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=20.0, seed=13, block_len=32_768)
    cap = sim.synthesize(scen)
    arrays = [np.real(cap.iq).astype(np.float32), np.imag(cap.iq).astype(np.float32),
              np.asarray(cap.buoy_enu, np.float32)]
    jcfg = jpipe.PipelineConfig(
        num_buoys=arrays[0].shape[0], block_len=32_768, sample_rate_hz=scen.sample_rate_hz,
        max_lag=600, power_offset_db=40.0, solver_iterations=20,
    )
    return cap, arrays, jcfg


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("max_lag,nfft,n1", [(600, 33_792, 128), (2048, 34_816, 256)])
def test_long_rows_step_matches_jax(scene, route, max_lag, nfft, n1, monkeypatch):
    cap, arrays, jcfg = scene
    jcfg = dataclasses.replace(jcfg, max_lag=max_lag)
    assert ct_plan.plan_nfft(32_768 + max_lag) == nfft and ct_plan.ct_split(nfft)[0] == n1
    assert fft_rows.geometry(nfft) == "long" and fft_detect.geometry(nfft) == "cluster"  # the card's designs:
    # the cluster K3 (two-kernel route), K1 in one launch of its cluster design (default route)
    knobs, (marks, kernels) = ROUTES[route]
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
    assert int(ours.peaks.bin_index.max()) < nfft and (ours.peaks.bin_index.numpy() >= 32_768).any()
    np.testing.assert_array_equal(ours.peaks.valid.numpy(), np.asarray(ref.peaks.valid))
    np.testing.assert_array_equal(ours.peaks.bin_index.numpy(), np.asarray(ref.peaks.bin_index))
    np.testing.assert_allclose(ours.peaks.noise_floor_db.numpy(), np.asarray(ref.peaks.noise_floor_db), atol=1e-3)
    np.testing.assert_allclose(
        ours.correlation.lag_samples.numpy(), np.asarray(ref.correlation.lag_samples), atol=1e-3
    )
    pos = ours.fix.position_enu.numpy()
    np.testing.assert_allclose(pos, np.asarray(ref.fix.position_enu), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 50.0
