"""Kernels K5 and K6 parity: the port's plain pair stages vs the JAX kernels.

The JAX side runs ``gcc_kernel.gcc_pairs_onehot_lag_mags`` (with the
PHAT chain's ``gather_precision="default"``) and
``gcc_kernel.gcc_rows_lag_mags`` in Pallas interpret mode, "phat" with
the per-pair "l2rx" gate scales ``s2``. On the CPU the one-hot gather
and the inverse products are plain float32, so the gather is exact.
Tolerance: lag windows within 1e-4 of each pair's window max, with the
same argmax — the same float32 whitening and four-step inverse, summed
in another order.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu.ops import gcc_phat as jgcc
from radio_mapper_tpu.ops.pallas import gcc_kernel

from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import assert_windows_close, correlated_spectra, pair_gate_scales, some_pairs

cap_cpu_threads()

SHAPES = [  # (B, nfft, max_lag, pairs): None = all pairs
    (8, 2048, 64, None),
    (5, 5120, 128, None),
    (9, 2048, 64, 37),  # not all pairs, not a multiple of the reference's chunk of 32
]


def _inputs(b, nfft, pairs, seed):
    sre, sim, smax = correlated_spectra(1, b, nfft, seed)
    pi, pj = jgcc.pair_indices(b) if pairs is None else some_pairs(b, pairs, seed)
    return sre[0], sim[0], pi, pj, pair_gate_scales(smax[0], pi, pj)


@pytest.mark.parametrize("b,nfft,max_lag,pairs", SHAPES)
def test_plain_k5_matches_pallas_interpret(b, nfft, max_lag, pairs):
    sre, sim, pi, pj, s2 = _inputs(b, nfft, pairs, seed=b)
    ref = np.asarray(
        gcc_kernel.gcc_pairs_onehot_lag_mags(
            sre, sim, pi, pj, max_lag=max_lag, eps=0.05, s2=s2,
            gather_precision="default", interpret=True,
        )
    )
    ours = gcc_pair.gcc_pairs_onehot_lag_mags(
        torch.from_numpy(sre), torch.from_numpy(sim), pi, pj,
        max_lag=max_lag, eps=0.05, s2=torch.from_numpy(s2),
    ).numpy()
    assert ours.shape == ref.shape == (len(pi), 2 * max_lag + 1)
    assert_windows_close(ours, ref)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("b,nfft,max_lag,pairs", SHAPES)
def test_plain_k6_matches_pallas_interpret(b, nfft, max_lag, pairs):
    sre, sim, pi, pj, s2 = _inputs(b, nfft, pairs, seed=b + 1)
    rows = [np.ascontiguousarray(x[idx]) for idx in (pi, pj) for x in (sre, sim)]
    ref = np.asarray(
        gcc_kernel.gcc_rows_lag_mags(*rows, max_lag=max_lag, eps=0.05, s2=s2, interpret=True)
    )
    ours = gcc_pair.gcc_rows_lag_mags(
        *(torch.from_numpy(r) for r in rows), max_lag=max_lag, eps=0.05, s2=torch.from_numpy(s2)
    ).numpy()
    assert ours.shape == ref.shape == (len(pi), 2 * max_lag + 1)
    assert_windows_close(ours, ref)
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


def test_plain_k5_leading_axis_equals_per_subchannel_calls():
    """[M, B, nfft] spectra + s2 [M, P] in one call = M calls (within
    float32 rounding: a batched product may block its sums differently)."""
    sre, sim, smax = correlated_spectra(3, 6, 2048, 11)
    pi, pj = jgcc.pair_indices(6)
    s2 = pair_gate_scales(smax, pi, pj)
    t = torch.from_numpy
    both = gcc_pair.gcc_pairs_onehot_lag_mags(t(sre), t(sim), pi, pj, max_lag=64, s2=t(s2))
    assert both.shape == (3, len(pi), 129)
    for m in range(3):
        one = gcc_pair.gcc_pairs_onehot_lag_mags(t(sre[m]), t(sim[m]), pi, pj, max_lag=64, s2=t(s2[m]))
        torch.testing.assert_close(both[m], one)


def test_plain_k6_equals_k5_on_gathered_rows():
    sre, sim, pi, pj, s2 = _inputs(7, 2048, None, seed=12)
    t = torch.from_numpy
    rows = [t(np.ascontiguousarray(x[idx])) for idx in (pi, pj) for x in (sre, sim)]
    k6 = gcc_pair.gcc_rows_lag_mags(*rows, max_lag=64, s2=t(s2))
    k5 = gcc_pair.gcc_pairs_onehot_lag_mags(t(sre), t(sim), pi, pj, max_lag=64, s2=t(s2))
    torch.testing.assert_close(k6, k5, rtol=0, atol=0)


@pytest.mark.parametrize("b,nfft", [(8, 5120), (64, 5120), (200, 5120), (201, 5120), (64, 17408)])
@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_onehot_route_gate_equals_reference(b, nfft, mode):
    gcc_kernel.set_onehot_pairs(mode)
    gcc_pair.set_onehot_pairs(mode)
    try:
        assert gcc_pair.onehot_pairs_enabled(b, nfft) == gcc_kernel.onehot_pairs_enabled(b, nfft)
    finally:
        gcc_kernel.set_onehot_pairs("auto")
        gcc_pair.set_onehot_pairs("auto")
    with pytest.raises(ValueError):
        gcc_pair.set_onehot_pairs("sometimes")


def test_k5_k6_wrappers_reject_bad_inputs():
    sre, sim, pi, pj, s2 = _inputs(4, 2048, None, seed=13)
    sre, sim, s2 = torch.from_numpy(sre), torch.from_numpy(sim), torch.from_numpy(s2)
    rows = [x.index_select(0, torch.as_tensor(idx, dtype=torch.int64)) for idx in (pi, pj) for x in (sre, sim)]
    # no gate scales: l2rx runs as l2; "cc" ignores them
    assert gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim, pi, pj, max_lag=64).shape == (len(pi), 129)
    assert gcc_pair.gcc_rows_lag_mags(*rows, max_lag=64, weighting="cc", s2=s2).shape == (len(pi), 129)
    with pytest.raises(ValueError):  # the fused pair stage takes "phat" and "cc" only
        gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim, pi, pj, max_lag=64, weighting="scot", s2=s2)
    with pytest.raises(ValueError):
        gcc_pair.gcc_rows_lag_mags(*rows, max_lag=64, weighting="roth")
    with pytest.raises(ValueError):  # pair index out of range
        gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim, pi, pj + 1, max_lag=64, s2=s2)
    with pytest.raises(ValueError):  # s2 of the wrong length
        gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim, pi, pj, max_lag=64, s2=s2[:-1])
    with pytest.raises(ValueError):
        gcc_pair.gcc_rows_lag_mags(*rows, max_lag=64, s2=s2[:-1])
    with pytest.raises(ValueError):  # lag window wider than half the transform
        gcc_pair.gcc_rows_lag_mags(*rows, max_lag=1024, s2=s2)
    with pytest.raises(ValueError):  # rows of different shapes
        gcc_pair.gcc_rows_lag_mags(rows[0], rows[1][:-1], rows[2], rows[3], max_lag=64, s2=s2)
