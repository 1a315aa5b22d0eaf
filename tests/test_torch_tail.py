"""Port parity for the tails around the kernels: top-K selection, the
detection tail, the GCC peak pick and the LM solver, vs the JAX package
with its safe mode forced on (the routing the flagship runs, with the
lowest-index tie-break).

Tolerances and why: selections (indices, validity, tie order) exactly —
integer decisions on identical float32 inputs; derived floats within
1e-6 relative (the same float32 formulas); the solver's position within
0.05 m on noise-free data (0.05 m + 1% of the 1σ major axis with noise)
and ellipse axes within 1e-3 relative (40 LM steps whose accept / reject
decisions may round differently, converging to the same minimum).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu import solver as jsolver
from radio_mapper_tpu.ops import detect as jdetect
from radio_mapper_tpu.ops import gcc_phat as jgcc
from radio_mapper_tpu.ops import safe as jsafe

from radio_mapper_tpu_torch import solver
from radio_mapper_tpu_torch.ops import detect, gcc_phat, safe
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


@pytest.fixture
def safe_mode():
    jsafe.set_safe_mode(True)
    try:
        yield
    finally:
        jsafe.set_safe_mode(None)


def _tied_scores(rows, s, seed):
    """Segment scores with −inf gaps, exact duplicates and an all −inf row."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(size=(rows, s)).astype(np.float32)
    x[rng.random(size=x.shape) < 0.7] = -np.inf
    x[0, 5] = x[0, 9] = x[0, 40] = np.float32(50.0)  # three-way tie at the top
    x[1] = -np.inf  # nothing detected
    x[2, :] = np.float32(1.0)  # everything tied
    return x


def test_top_k_tie_break_matches(safe_mode):
    x = _tied_scores(4, 96, 0)
    jv, ji = jsafe.top_k(jnp.asarray(x), 8)
    tv, ti = safe.top_k(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0, :3].tolist() == [5, 9, 40]
    assert ti[1].tolist() == [0] * 8


@pytest.mark.parametrize("nfft,seed", [(5120, 1), (9216, 2)])
def test_peaks_from_ct_partials_matches(safe_mode, nfft, seed):
    s = nfft // 8
    score = 1e3 * _tied_scores(6, s, seed)
    arg = np.random.default_rng(seed + 10).integers(0, 8, size=score.shape).astype(np.float32)
    nf = np.random.default_rng(seed + 20).normal(-20.0, 3.0, size=(6,)).astype(np.float32)
    kw = dict(nfft=nfft, sample_rate_hz=2.4e6, max_peaks=8, power_offset_db=40.0)
    ref = jdetect.peaks_from_ct_partials(jnp.asarray(score), jnp.asarray(arg), jnp.asarray(nf), **kw)
    ours = detect.peaks_from_ct_partials(
        torch.from_numpy(score), torch.from_numpy(arg), torch.from_numpy(nf), **kw
    )
    for f in ("bin_index", "valid"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f)
    for f in ("freq_offset_hz", "power_db", "snr_db", "confidence", "noise_floor_db"):
        np.testing.assert_allclose(
            getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-6, atol=1e-6, err_msg=f
        )


def _windows(rows, width, seed):
    rng = np.random.default_rng(seed)
    m = rng.exponential(size=(rows, width)).astype(np.float32)
    lag = rng.integers(2, width - 2, size=rows)
    for r, k in enumerate(lag):
        m[r, k - 1 : k + 2] += np.float32([20.0, 30.0, 25.0])
    m[0, 3] = m[0, 200] = np.float32(100.0)  # tied peaks: lowest lag wins
    m[1, 0] = np.float32(100.0)  # peak on the window edge: no refinement
    m[2, :] = np.float32(1.0)  # flat: degenerate parabola
    return m


def test_peaks_from_lag_mags_matches(safe_mode):
    m = _windows(7, 2 * 256 + 1, 3)
    ref = jgcc.peaks_from_lag_mags(jnp.asarray(m), sample_rate_hz=2.048e6, max_lag=256)
    ours = gcc_phat.peaks_from_lag_mags(torch.from_numpy(m), sample_rate_hz=2.048e6, max_lag=256)
    for f in ours._fields:
        np.testing.assert_allclose(
            getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-6, atol=1e-9, err_msg=f
        )
    assert round(ours.lag_samples[0].item()) == 3 - 256  # the lower of the tied lags


def test_pair_indices_equal():
    for b in (2, 4, 8):
        for a, r in zip(gcc_phat.pair_indices(b), jgcc.pair_indices(b)):
            np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("noise_m", [0.0, 5.0])
@pytest.mark.parametrize("num_receivers,seed", [(4, 0), (5, 1), (8, 2)])
def test_solver_matches(num_receivers, seed, noise_m):
    """Noise-free: both land on the emitter, within 0.05 m of each other
    (σ is then given, 1 m, since residuals hold only rounding noise).
    With 5 m of dd noise the minimum of a poor geometry is a shallow
    valley that float32 cost comparisons resolve only to a fraction of
    its 1σ ellipse, so the bound there is 0.05 m + 1% of the major axis."""
    rng = np.random.default_rng(seed)
    batch = 6
    anchors = rng.normal(scale=8_000.0, size=(batch, num_receivers, 3)).astype(np.float32)
    anchors[..., 2] = 0.0
    emitter = rng.normal(scale=3_000.0, size=(batch, 3))
    emitter[..., 2] = 0.0
    pi, pj = jgcc.pair_indices(num_receivers)
    d = np.linalg.norm(emitter[:, None, :] - anchors, axis=-1)
    dd = (d[:, pi] - d[:, pj] + rng.normal(scale=5.0, size=(batch, len(pi))) * noise_m).astype(np.float32)
    w = rng.uniform(0.2, 1.0, size=dd.shape).astype(np.float32)
    w[0] = 0.0  # all-zero weights degrade to uniform

    sigma = 1.0 if noise_m == 0.0 else None
    ref = jsolver.solve_tdoa(anchors, pi, pj, dd, w, iterations=40, sigma_m=sigma)
    ours = solver.solve_tdoa_impl(
        torch.from_numpy(anchors), torch.from_numpy(pi), torch.from_numpy(pj),
        torch.from_numpy(dd), torch.from_numpy(w), iterations=40,
        sigma_m=None if sigma is None else torch.tensor(sigma),
    )
    major = np.asarray(ref.ellipse_major_m)
    gap = np.linalg.norm(ours.position_enu.numpy() - np.asarray(ref.position_enu), axis=-1)
    assert (gap <= 0.05 + 0.01 * major).all(), (gap, major)
    if noise_m == 0.0:
        assert gap.max() <= 0.05, gap
    for f in ("ellipse_major_m", "ellipse_minor_m"):
        np.testing.assert_allclose(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-3)
    np.testing.assert_array_equal(ours.num_measurements.numpy(), np.asarray(ref.num_measurements))
    # the fix itself is good: within a few 1σ ellipses of the truth
    err = np.linalg.norm(ours.position_enu.numpy()[..., :2] - emitter[..., :2], axis=-1)
    assert (err <= 1.0 + 5.0 * major).all(), (err, major)


def test_solver_3d_and_known_sigma_match():
    rng = np.random.default_rng(7)
    anchors = rng.normal(scale=5_000.0, size=(6, 3)).astype(np.float32)
    anchors[:, 2] = rng.uniform(0, 800, size=6)
    emitter = np.array([300.0, -900.0, 400.0])
    pi, pj = jgcc.pair_indices(6)
    d = np.linalg.norm(emitter - anchors, axis=-1)
    dd = (d[pi] - d[pj]).astype(np.float32)
    kw = dict(solve_2d=False, iterations=40, sigma_m=3.0, sigma_floor_m=1.0)
    ref = jsolver.solve_tdoa(anchors, pi, pj, dd, None, **kw)
    ours = solver.solve_tdoa_impl(
        torch.from_numpy(anchors), torch.from_numpy(pi), torch.from_numpy(pj), torch.from_numpy(dd),
        None, solve_2d=False, iterations=40,
        sigma_m=torch.tensor(3.0), sigma_floor_m=torch.tensor(1.0),
    )
    np.testing.assert_allclose(ours.position_enu.numpy(), np.asarray(ref.position_enu), atol=0.05)
    np.testing.assert_allclose(ours.cov_enu.numpy(), np.asarray(ref.cov_enu), rtol=1e-3, atol=1e-3)
