"""Kernel K3 parity: the port's plain CT-order FFT vs the JAX Pallas kernel.

The JAX side runs ``fft_kernel.fft_rows_ct`` in Pallas interpret mode with
``precision="default"`` — what the wideband PHAT chain passes, and plain
float32 on the CPU (``precision=None`` would run explicit bf16x3 products
even on the CPU). Tolerance: spectra within 1e-4 of each row's max |X|,
the same four-step float32 math on bit-identical tables, summed in
another order.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu.ops.pallas import fft_kernel

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_detect, fft_rows
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import DET, assert_spectra_close, tone_rows

cap_cpu_threads()


@pytest.mark.parametrize("rows,nfft,seed", [(6, 5120, 0), (3, 2048, 1)])
def test_plain_k3_matches_pallas_interpret(rows, nfft, seed):
    re, im = tone_rows(rows, nfft, seed, n_valid=nfft - nfft // 5)
    ref = fft_kernel.fft_rows_ct(re, im, precision="default", interpret=True)
    ours = fft_rows.fft_rows_ct(torch.from_numpy(re), torch.from_numpy(im))
    assert_spectra_close([o.numpy() for o in ours], [np.asarray(r) for r in ref])


def test_plain_k3_keeps_leading_axes_and_feeds_k1():
    """[M, B, nfft] in, the same shape out; K1's plain version runs the
    same transform, bit for bit."""
    re, im = tone_rows(6, 5120, 3)
    xr, xi = torch.from_numpy(re), torch.from_numpy(im)
    fr, fi = fft_rows.fft_rows_ct(xr.reshape(2, 3, 5120), xi.reshape(2, 3, 5120))
    assert fr.shape == fi.shape == (2, 3, 5120)
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, ct_plan.detect_plan(5120, **DET))
    torch.testing.assert_close(fr.reshape(6, 5120), k1[0], rtol=0, atol=0)
    torch.testing.assert_close(fi.reshape(6, 5120), k1[1], rtol=0, atol=0)


def test_k3_wrapper_rejects_bad_inputs():
    x = torch.zeros(2, 5120)
    with pytest.raises(ValueError):  # shapes differ
        fft_rows.fft_rows_ct(x, torch.zeros(2, 4096))
    with pytest.raises(TypeError):
        fft_rows.fft_rows_ct(x.double(), x.double())
    with pytest.raises(ValueError):  # not contiguous
        fft_rows.fft_rows_ct(torch.zeros(5120, 2).t(), torch.zeros(5120, 2).t())
    with pytest.raises(ValueError):  # no CT split
        fft_rows.fft_rows_ct(torch.zeros(2, 1000), torch.zeros(2, 1000))
