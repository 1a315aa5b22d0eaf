"""The single-dwell step and the pair stage at the mixed-radix inner lengths
(n1 = 384, 640, 896): the port vs JAX.

Planned lengths whose split has n1 ∈ {384, 640, 896} run, on the card,
the mixed-radix warp FFT (``tests/test_torch_mixed_radix.py``): in the
long K3's row pass (and so K1's long rows) and in the pair body of K2, K5
and K6. On the CPU both packages run their plain four-step versions.

- ``step_split`` at block_len 57344 and max_lag 600, the first planned
  length of the set a user reaches with a 57344-sample dwell: nfft 58368
  = 384·152, on the default route (K1 → K2) and the two-kernel route (K3
  → K4 → K2), the JAX side forced onto the same route as
  ``tests/test_torch_routes.py`` forces it (Pallas in interpret mode).
  Tolerances of ``tests/test_torch_long_rows.py``: detections exactly,
  the floor within 1e-3 dB, lags within 1e-3 samples, the fix within
  0.5 m of JAX's and under 50 m from the emitter.
- ``step_split`` at block_len 96000 (nfft 97280 = 640·152, the wide K1 at
  n1 = 640 on the card) on the default route, with the same tolerances.
- K2 and K5's plain windows vs the Pallas kernels in interpret mode at
  nfft 87040 = 640·136 and 121856 = 896·136, within 1e-4 of each
  window's max (``tests/test_torch_gcc_pair.py``'s tolerance).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radio_mapper_tpu.models import pipeline as jpipe
from radio_mapper_tpu.ops import gcc_phat as jgcc
from radio_mapper_tpu.ops.pallas import gcc_kernel

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.models import pipeline
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import channel_step, fft_detect, fft_rows, gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from test_torch_cuda import assert_windows_close, correlated_spectra, pair_gate_scales
from test_torch_routes import FUSED, TWO_KERNEL, _forced, _spy_wrappers

cap_cpu_threads()

ROUTES = {"default": ({}, FUSED), "two-kernel": ({"fft_detect": "off"}, TWO_KERNEL)}
BLOCK_LEN, MAX_LAG, NFFT = 57_344, 600, 58_368


def _scene(block_len):
    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=20.0, seed=13, block_len=block_len)
    cap = sim.synthesize(scen)
    arrays = [np.real(cap.iq).astype(np.float32), np.imag(cap.iq).astype(np.float32),
              np.asarray(cap.buoy_enu, np.float32)]
    jcfg = jpipe.PipelineConfig(
        num_buoys=arrays[0].shape[0], block_len=block_len, sample_rate_hz=scen.sample_rate_hz,
        max_lag=MAX_LAG, power_offset_db=40.0, solver_iterations=20,
    )
    return cap, arrays, jcfg


@pytest.fixture(scope="module")
def scene():
    return _scene(BLOCK_LEN)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_mixed_radix_step_matches_jax(scene, route, monkeypatch):
    assert ct_plan.plan_nfft(BLOCK_LEN + MAX_LAG) == NFFT and ct_plan.ct_split(NFFT) == (384, 152)
    _step_matches_jax(scene, NFFT, 384, route, monkeypatch)


def test_mixed_radix_step_matches_jax_at_block_len_96000(monkeypatch):
    """The flagship's dwell at block_len 96000: nfft 97280 = 640·152, where
    the card runs K1 in one launch of the wide design at n1 = 640."""
    assert ct_plan.plan_nfft(96_000 + MAX_LAG) == 97_280 and ct_plan.ct_split(97_280) == (640, 152)
    assert fft_rows.long_geometry(97_280).design == "wide"
    _step_matches_jax(_scene(96_000), 97_280, 640, "default", monkeypatch)


def _step_matches_jax(scene, nfft, n1, route, monkeypatch):
    cap, arrays, jcfg = scene
    # the card's designs: the wide K1/K3 (row pass P = n1/32), K2's mixed body, K8's long design
    assert fft_rows.geometry(nfft) == channel_step.geometry(nfft) == "long" and fft_detect.geometry(nfft) == "wide"
    assert gcc_pair._geometry(nfft, MAX_LAG, "K2")[0] == n1
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
    assert int(ours.peaks.bin_index.max()) < nfft
    np.testing.assert_array_equal(ours.peaks.valid.numpy(), np.asarray(ref.peaks.valid))
    np.testing.assert_array_equal(ours.peaks.bin_index.numpy(), np.asarray(ref.peaks.bin_index))
    np.testing.assert_allclose(ours.peaks.noise_floor_db.numpy(), np.asarray(ref.peaks.noise_floor_db), atol=1e-3)
    np.testing.assert_allclose(
        ours.correlation.lag_samples.numpy(), np.asarray(ref.correlation.lag_samples), atol=1e-3
    )
    pos = ours.fix.position_enu.numpy()
    np.testing.assert_allclose(pos, np.asarray(ref.fix.position_enu), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 50.0


@pytest.mark.parametrize("nfft,n1", [(87_040, 640), (121_856, 896)])
def test_plain_k2_matches_pallas_interpret_at_mixed_n1(nfft, n1):
    b, max_lag = 3, MAX_LAG
    assert ct_plan.ct_split(nfft)[0] == n1
    sre, sim_, smax = correlated_spectra(1, b, nfft, n1)
    pi, pj = jgcc.pair_indices(b)
    ref = np.asarray(gcc_kernel.gcc_pair_lag_mags(
        sre, sim_, pi, pj, max_lag=max_lag, eps=0.05, row_smax=smax, interpret=True
    ))
    ours = gcc_pair.gcc_pair_lag_mags(
        torch.from_numpy(sre), torch.from_numpy(sim_), torch.from_numpy(smax), pi, pj, max_lag=max_lag, eps=0.05,
    ).numpy()
    assert ours.shape == ref.shape == (1, len(pi), 2 * max_lag + 1)
    assert_windows_close(ours, ref)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("nfft,n1", [(87_040, 640), (121_856, 896)])
def test_plain_k5_matches_pallas_interpret_at_mixed_n1(nfft, n1):
    b, max_lag = 3, MAX_LAG
    assert ct_plan.ct_split(nfft)[0] == n1
    sre, sim_, smax = (a[0] for a in correlated_spectra(1, b, nfft, n1 + 1))
    pi, pj = np.array([0, 0, 1, 2]), np.array([1, 2, 2, 0])
    s2 = pair_gate_scales(smax, pi, pj)
    ref = np.asarray(gcc_kernel.gcc_pairs_onehot_lag_mags(
        sre, sim_, pi, pj, max_lag=max_lag, eps=0.05, s2=s2, gather_precision="default", interpret=True,
    ))
    ours = gcc_pair.gcc_pairs_onehot_lag_mags(
        torch.from_numpy(sre), torch.from_numpy(sim_), pi, pj, max_lag=max_lag, eps=0.05,
        s2=torch.from_numpy(s2),
    ).numpy()
    assert ours.shape == ref.shape == (len(pi), 2 * max_lag + 1)
    assert_windows_close(ours, ref)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))
