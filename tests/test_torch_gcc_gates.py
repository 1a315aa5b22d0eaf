"""K2's whitening modes: the port's plain pair stages vs the JAX Pallas kernels.

The JAX side runs ``gcc_kernel.gcc_pair_lag_mags`` (and, for the wideband
path, ``gcc_pairs_onehot_lag_mags``/``gcc_rows_lag_mags``; from signals,
``split_complex.gcc_phat_all_pairs_split_fused``) in Pallas
interpret mode under ``gcc_kernel.set_phat_gate`` — "l2rx" (per-receiver
gate scales), "l2" and "l1" (the pair's own maximum) — and with
``weighting="cc"`` (not whitened); the port runs under the same
``gcc_pair.set_phat_gate``. Both knobs are set in ``try/finally`` and put
back to "l2rx".

Tolerance: lag windows within 1e-4 of each pair's window max, with the
same argmax. For PHAT both sides run the same float32 whitening and
four-step inverse, summed in another order. For "cc" the reference's
inverse (and its one-hot gather) runs at HIGH, explicit bf16x3 even in
interpret mode, and the port at float32: bf16x3 keeps about 16 mantissa
bits, 1e-5 of a window's max, far inside the 1e-4 bound and the 0.1
sample τ budget of ROADMAP "Facts".
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu.ops import gcc_phat as jgcc
from radio_mapper_tpu.ops import split_complex as jsc
from radio_mapper_tpu.ops.pallas import gcc_kernel

from radio_mapper_tpu_torch.ops import split_complex as sc
from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import assert_windows_close, correlated_spectra, pair_gate_scales

cap_cpu_threads()

MODES = [("l2rx", "phat"), ("l2", "phat"), ("l1", "phat"), ("l2rx", "cc")]


def _under_gate(gate, fn):
    gcc_kernel.set_phat_gate(gate)
    gcc_pair.set_phat_gate(gate)
    try:
        return fn()
    finally:
        gcc_kernel.set_phat_gate("l2rx")
        gcc_pair.set_phat_gate("l2rx")


@pytest.mark.parametrize("gate,weighting", MODES)
@pytest.mark.parametrize("c,b,nfft,max_lag,seed", [(3, 4, 5120, 128, 0), (1, 5, 9216, 256, 1)])
def test_plain_k2_modes_match_pallas_interpret(gate, weighting, c, b, nfft, max_lag, seed):
    sre, sim, smax = correlated_spectra(c, b, nfft, seed)
    pi, pj = jgcc.pair_indices(b)
    ref = _under_gate(gate, lambda: np.asarray(gcc_kernel.gcc_pair_lag_mags(
        sre, sim, pi, pj, max_lag=max_lag, eps=0.05, weighting=weighting, row_smax=smax, interpret=True
    )))
    ours = _under_gate(gate, lambda: gcc_pair.gcc_pair_lag_mags(
        torch.from_numpy(sre), torch.from_numpy(sim), torch.from_numpy(smax), pi, pj,
        max_lag=max_lag, eps=0.05, weighting=weighting,
    ).numpy())
    assert ours.shape == ref.shape == (c, len(pi), 2 * max_lag + 1)
    assert_windows_close(ours, ref)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


def test_l2rx_without_row_maxima_is_l2():
    """The reference's fallback: "l2rx" with no ``row_smax`` runs as "l2"."""
    sre, sim, smax = (torch.from_numpy(a) for a in correlated_spectra(2, 4, 5120, 2))
    pi, pj = jgcc.pair_indices(4)
    fallback = gcc_pair.gcc_pair_lag_mags(sre, sim, None, pi, pj, max_lag=128)
    l2 = _under_gate("l2", lambda: gcc_pair.gcc_pair_lag_mags(sre, sim, smax, pi, pj, max_lag=128))
    torch.testing.assert_close(fallback, l2, rtol=0, atol=0)
    gated = gcc_pair.gcc_pair_lag_mags(sre, sim, smax, pi, pj, max_lag=128)
    assert not torch.equal(gated, l2)  # l2rx does use the per-receiver maxima
    cc = gcc_pair.gcc_pair_lag_mags(sre, sim, None, pi, pj, max_lag=128, weighting="cc")
    torch.testing.assert_close(
        cc, gcc_pair.gcc_pair_lag_mags_plain(sre, sim, smax, pi, pj, max_lag=128, weighting="cc"),
        rtol=0, atol=0,
    )


@pytest.mark.parametrize("gate,weighting", MODES)
def test_plain_k5_k6_modes_match_pallas_interpret(gate, weighting):
    """The wideband pair stages under every mode; the l2rx gate scales are
    passed only where the reference's wideband path passes them."""
    b, nfft, max_lag = 6, 2048, 64
    sre, sim, smax = correlated_spectra(1, b, nfft, 3)
    sre, sim, smax = sre[0], sim[0], smax[0]
    pi, pj = jgcc.pair_indices(b)
    s2 = pair_gate_scales(smax, pi, pj) if (gate, weighting) == ("l2rx", "phat") else None
    rows = [np.ascontiguousarray(x[idx]) for idx in (pi, pj) for x in (sre, sim)]
    ts2 = None if s2 is None else torch.from_numpy(s2)
    ref5 = _under_gate(gate, lambda: np.asarray(gcc_kernel.gcc_pairs_onehot_lag_mags(
        sre, sim, pi, pj, max_lag=max_lag, eps=0.05, weighting=weighting, s2=s2,
        gather_precision="default" if weighting == "phat" else None, interpret=True,
    )))
    ref6 = _under_gate(gate, lambda: np.asarray(gcc_kernel.gcc_rows_lag_mags(
        *rows, max_lag=max_lag, eps=0.05, weighting=weighting, s2=s2, interpret=True
    )))
    ours5 = _under_gate(gate, lambda: gcc_pair.gcc_pairs_onehot_lag_mags(
        torch.from_numpy(sre), torch.from_numpy(sim), pi, pj, max_lag=max_lag, eps=0.05,
        weighting=weighting, s2=ts2,
    ).numpy())
    ours6 = _under_gate(gate, lambda: gcc_pair.gcc_rows_lag_mags(
        *(torch.from_numpy(r) for r in rows), max_lag=max_lag, eps=0.05, weighting=weighting, s2=ts2,
    ).numpy())
    for ours, ref in ((ours5, ref5), (ours6, ref6)):
        assert ours.shape == ref.shape == (len(pi), 2 * max_lag + 1)
        assert_windows_close(ours, ref)
        np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


def test_gate_knob_and_weightings():
    assert gcc_pair.phat_gate() == "l2rx"
    with pytest.raises(ValueError):
        gcc_pair.set_phat_gate("l3")
    assert gcc_pair.resolve_gate("cc", True) == "none"
    assert gcc_pair.resolve_gate("phat", True) == "l2rx"
    assert gcc_pair.resolve_gate("phat", False) == "l2"
    for gate in ("l1", "l2"):
        assert _under_gate(gate, lambda: gcc_pair.resolve_gate("phat", True)) == gate
    with pytest.raises(ValueError):  # as the reference: the fused stage takes phat and cc
        gcc_pair.resolve_gate("scot", True)
    assert gcc_pair.WEIGHTINGS == gcc_kernel.WEIGHTINGS


@pytest.mark.parametrize("weighting,with_maxima", [("phat", True), ("phat", False), ("cc", False)])
def test_gcc_phat_all_pairs_split_fused_matches_jax(weighting, with_maxima):
    """The fused pair stage from signals: CT spectra (K3), K2 under the
    gate the arguments select, then the peak pick; lags within 1e-3
    samples, as the pipelines' tests."""
    rng = np.random.default_rng(21)
    c, b, n, lag = 2, 4, 4096, 128
    src = rng.normal(size=(c, n + 64)) + 1j * rng.normal(size=(c, n + 64))
    shifts = rng.integers(0, 60, size=(c, b))
    x = np.stack([[src[k, s:s + n] for s in shifts[k]] for k in range(c)])
    x = x + 0.3 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    re, im = x.real.astype(np.float32), x.imag.astype(np.float32)
    kw = dict(sample_rate_hz=2.4e6, max_lag=lag, weighting=weighting, eps=0.05)
    spectra = sc.receiver_spectra_ct(torch.from_numpy(re), torch.from_numpy(im), max_lag=lag)
    smax = (spectra[0] ** 2 + spectra[1] ** 2).amax(-1) if with_maxima else None
    ours = sc.gcc_phat_all_pairs_split_fused(
        torch.from_numpy(re), torch.from_numpy(im), **kw, spectra=spectra, row_smax=smax
    )
    ref = jsc.gcc_phat_all_pairs_split_fused(
        re, im, **kw, row_smax=None if smax is None else smax.numpy()
    )
    np.testing.assert_allclose(ours.lag_samples.numpy(), np.asarray(ref.lag_samples), atol=1e-3)
    np.testing.assert_allclose(ours.psr.numpy(), np.asarray(ref.psr), rtol=1e-3)
    # the planted shifts: x_i is src delayed by −shift_i, so lag(i, j) = shift_j − shift_i
    pi, pj = jgcc.pair_indices(b)
    np.testing.assert_allclose(ours.lag_samples.numpy(), shifts[:, pj] - shifts[:, pi], atol=0.5)
