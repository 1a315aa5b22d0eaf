"""Kernel K1 parity: the port's plain FFT + detect vs the JAX Pallas kernel.

The JAX side runs ``detect_kernel.fft_detect_rows_ct`` in Pallas interpret
mode with the PHAT chain's forward precision ("default": plain float32 on
the CPU). Tolerances and why:

- spectra within 1e-4 of each row's max |X|: the same four-step float32
  math, summed in another order;
- ``row_max`` within 1e-5 relative (power of those spectra);
- ``noise_floor_db`` within 1e-3 dB: ``log10`` differs by ulps between
  libraries, so the 24-step bisection can land a hair apart;
- segment partials: scores within 1e-4 of the row's max power; the
  candidate pattern and in-segment argmax exactly, except in segments
  whose decision sits within float32 noise of a tie (a neighbour, the
  threshold or the confidence gate within 1e-4 relative), which are
  counted and must stay rare.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu.ops.pallas import detect_kernel

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_detect
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import DET, assert_k1_close, tone_rows

cap_cpu_threads()

@pytest.mark.parametrize("nfft,n_valid,seed", [
    (5120, 4096, 1), (9216, 8192, 2),
    (58368, 57344, 3),  # 384·152, the flagship at block_len 57344 (the wide K1 on the card)
    (52224, 51200, 4),  # 384·136, the shortest n1 = 384 length
    (97280, 96000, 5),  # 640·152, the flagship at block_len 96000 (the wide K1 at n1 = 640)
    (121856, 121000, 6),  # 896·136, block_len 121000 (the wide K1 at n1 = 896)
])
def test_plain_k1_matches_pallas_interpret(nfft, n_valid, seed):
    re, im = tone_rows(5, nfft, seed, n_valid=n_valid)
    ref = detect_kernel.fft_detect_rows_ct(re, im, **DET, interpret=True, precision="default")
    plan = ct_plan.detect_plan(nfft, **DET)
    out = fft_detect.fft_detect_rows_ct(torch.from_numpy(re), torch.from_numpy(im), plan)
    assert_k1_close(out, ref, plan)


def test_plain_k1_conf_floor_above_one_passes_nothing():
    """confidence_floor > 1 can never pass: all partials −inf, while the
    noise floor is still reported (and matches the reference)."""
    re, im = tone_rows(3, 5120, 7)
    det = dict(DET, confidence_floor=1.5)
    ref = detect_kernel.fft_detect_rows_ct(re, im, **det, interpret=True, precision="default")
    out = fft_detect.fft_detect_rows_ct(
        torch.from_numpy(re), torch.from_numpy(im), ct_plan.detect_plan(5120, **det)
    )
    assert torch.isneginf(out[2]).all()
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4]), atol=1e-3, rtol=0)


def test_k1_wrapper_rejects_bad_inputs():
    plan = ct_plan.detect_plan(5120, **DET)
    x = torch.zeros(2, 5120)
    with pytest.raises(ValueError):
        fft_detect.fft_detect_rows_ct(x, torch.zeros(2, 4096), plan)
    with pytest.raises(TypeError):
        fft_detect.fft_detect_rows_ct(x.double(), x.double(), plan)
    with pytest.raises(ValueError):
        fft_detect.fft_detect_rows_ct(torch.zeros(5120, 2).t(), torch.zeros(5120, 2).t(), plan)
