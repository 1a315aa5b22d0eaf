"""Kernel K2 parity: the port's plain pair stage vs the JAX Pallas kernel.

The JAX side runs ``gcc_kernel.gcc_pair_lag_mags`` in Pallas interpret
mode on the main path's routing ("phat", the per-receiver "l2rx" gate fed
with ``row_smax``, the one-hot gather — exact on the CPU). Tolerance:
lag windows within 1e-4 of each pair's window max — the same float32
whitening and four-step inverse, summed in another order.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu.ops import gcc_phat as jgcc
from radio_mapper_tpu.ops.pallas import gcc_kernel

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import gcc_pair

from test_torch_cuda import assert_windows_close, correlated_spectra


@pytest.mark.parametrize(
    "c,b,nfft,max_lag,seed", [(2, 4, 5120, 128, 0), (1, 5, 9216, 256, 1), (1, 3, 5120, 300, 2)]
)
def test_plain_k2_matches_pallas_interpret(c, b, nfft, max_lag, seed):
    sre, sim, smax = correlated_spectra(c, b, nfft, seed)
    pi, pj = jgcc.pair_indices(b)
    ref = np.asarray(
        gcc_kernel.gcc_pair_lag_mags(
            sre, sim, pi, pj, max_lag=max_lag, eps=0.05, row_smax=smax, interpret=True
        )
    )
    ours = gcc_pair.gcc_pair_lag_mags(
        torch.from_numpy(sre), torch.from_numpy(sim), torch.from_numpy(smax), pi, pj,
        max_lag=max_lag, eps=0.05,
    ).numpy()
    assert ours.shape == ref.shape == (c, len(pi), 2 * max_lag + 1)
    assert_windows_close(ours, ref)
    # the planted delays show up as the window peaks in both
    np.testing.assert_array_equal(ours.argmax(-1), ref.argmax(-1))


def test_window_rows_match_reference_formula():
    for nfft, lag in ((17408, 512), (17408, 600), (5120, 128), (9216, 256)):
        n1, _ = ct_plan.ct_split(nfft)
        assert gcc_pair.window_rows(nfft, lag) == (-(-lag // n1), lag // n1 + 1)


def test_k2_wrapper_rejects_bad_inputs():
    sre, sim, smax = (torch.from_numpy(a) for a in correlated_spectra(1, 3, 5120, 3))
    pi, pj = jgcc.pair_indices(3)
    with pytest.raises(ValueError):  # pair index out of range
        gcc_pair.gcc_pair_lag_mags(sre, sim, smax, pi, pj + 1, max_lag=64)
    with pytest.raises(ValueError):  # lag window wider than half the transform
        gcc_pair.gcc_pair_lag_mags(sre, sim, smax, pi, pj, max_lag=2560)
    with pytest.raises(ValueError):  # row_smax of the wrong shape
        gcc_pair.gcc_pair_lag_mags(sre, sim, smax[:, :2], pi, pj, max_lag=64)
