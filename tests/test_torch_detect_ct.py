"""Kernel K4 parity: the port's plain CT-order detect vs the JAX Pallas kernel.

The JAX side runs ``detect_kernel.detect_ct_partials`` in Pallas interpret
mode and ``detect.detect_peaks_ct`` with its safe mode forced on (what the
TPU runs). Both packages read the same float32 CT-order spectra, made
with numpy from tone-plus-noise rows. Tolerances are K1's
(``test_torch_fft_detect.py``) and why:

- ``noise_floor_db`` within 1e-3 dB: ``log10`` differs by ulps between
  libraries, so the 24-step bisection can land a hair apart;
- segment scores within 1e-4 of the row's max power, and the candidate
  pattern and in-segment argmax exactly, except in segments whose decision
  sits within float32 noise of a tie (``fragile_segments``), which must
  stay rare;
- as a ``PeakSet``: bins and validity exactly; power, SNR (dB) and
  frequency (Hz) within 2e-3 — the floor's 1e-3 dB slack enters the SNR.
  Exactly-equal peaks in different segments could tie-break differently
  (ROADMAP "CT bin order"); these spectra hold none.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu.ops import detect as jdetect
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops.pallas import detect_kernel

from radio_mapper_tpu_torch.ops import ct_plan, detect
from radio_mapper_tpu_torch.ops.cuda import detect_ct, fft_detect
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import DET, assert_partials_close, tone_rows

cap_cpu_threads()


def ct_spectra(rows, nfft, seed, n_valid):
    """float32 CT-order spectra of ``tone_rows`` (numpy FFT, then the CT
    permutation)."""
    re, im = tone_rows(rows, nfft, seed, n_valid=n_valid)
    spec = np.fft.fft(re.astype(np.float64) + 1j * im)[..., ct_plan.ct_permutation(nfft)]
    return np.ascontiguousarray(spec.real, np.float32), np.ascontiguousarray(spec.imag, np.float32)


@pytest.mark.parametrize("nfft,n_valid,seed", [(5120, 4096, 1), (9216, 8192, 2)])
def test_plain_k4_matches_pallas_interpret(nfft, n_valid, seed):
    fr, fi = ct_spectra(6, nfft, seed, n_valid)
    ref = detect_kernel.detect_ct_partials(fr, fi, **DET, interpret=True)
    plan = ct_plan.detect_plan(nfft, **DET)
    before = detect_ct.launch_count
    ours = detect_ct.detect_ct_partials(torch.from_numpy(fr), torch.from_numpy(fi), plan)
    assert detect_ct.launch_count == before  # the CPU runs the plain version
    assert [tuple(x.shape) for x in ours] == [(6, nfft // 8), (6, nfft // 8), (6,)]
    assert_partials_close(ours, ref, fr, fi, plan)


def test_plain_k4_equals_the_detect_half_of_k1():
    """On K1's own spectra, K4 gives K1's partials and floor exactly."""
    re, im = tone_rows(4, 9216, 3, n_valid=8192)
    plan = ct_plan.detect_plan(9216, **DET)
    fr, fi, score, arg, nf, _rmax = fft_detect.fft_detect_rows_ct(
        torch.from_numpy(re), torch.from_numpy(im), plan
    )
    for a, b in zip(detect_ct.detect_ct_partials(fr, fi, plan), (score, arg, nf)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("batch", [(5,), (2, 3)])
def test_detect_peaks_ct_matches_jax(batch):
    rows = int(np.prod(batch))
    fr, fi = ct_spectra(rows, 9216, 4, 8192)
    fr, fi = fr.reshape(*batch, 9216), fi.reshape(*batch, 9216)
    kw = dict(DET, max_peaks=6)
    jsafe.set_safe_mode(True)
    try:
        ref = jdetect.detect_peaks_ct(fr, fi, **kw)
    finally:
        jsafe.set_safe_mode(None)
    ours = detect.detect_peaks_ct(torch.from_numpy(fr), torch.from_numpy(fi), **kw)
    assert ours.valid.any()
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.bin_index.numpy(), np.asarray(ref.bin_index))
    for f in ("power_db", "snr_db", "freq_offset_hz"):
        np.testing.assert_allclose(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), atol=2e-3, rtol=1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(ours.noise_floor_db.numpy(), np.asarray(ref.noise_floor_db), atol=1e-3)
    # the same peaks from partials handed in (K1's route)
    plan = ct_plan.detect_plan(9216, **DET)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.reshape(-1, 9216)))
    score, arg, nf = detect_ct.detect_ct_partials(t(fr), t(fi), plan)
    s = plan.segments
    again = detect.detect_peaks_ct(
        torch.from_numpy(fr), torch.from_numpy(fi), **kw,
        partials=(score.reshape(*batch, s), arg.reshape(*batch, s), nf.reshape(batch)),
    )
    for a, b in zip(again, ours):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("nfft", [1024, 2048, 5120, 9216, 17408, 17280])
@pytest.mark.parametrize("radius,stride", [(10, 8), (10, 4), (6, 8), (200, 8)])
def test_supported_and_routing_knobs_match_reference(nfft, radius, stride):
    kw = dict(min_distance_bins=radius, noise_floor_stride=stride)
    assert detect_ct.supported(nfft, **kw) == detect_kernel.supported(nfft, **kw)
    # the reference's "auto" asks for a TPU backend; the port's is the TPU's
    jsafe.set_safe_mode(True)
    try:
        for fused in ("on", "off"):
            for fft_fused in ("auto", "on", "off"):
                detect.set_fused_detect(fused)
                jdetect.set_fused_detect(fused)
                detect.set_fused_fft_detect(fft_fused)
                jdetect.set_fused_fft_detect(fft_fused)
                try:
                    assert detect.fused_detect_enabled(nfft, **kw) == jdetect.fused_detect_enabled(nfft, **kw)
                    assert (detect.fused_fft_detect_enabled(nfft, **kw)
                            == jdetect.fused_fft_detect_enabled(nfft, **kw))
                finally:
                    for knob in (detect.set_fused_detect, jdetect.set_fused_detect,
                                 detect.set_fused_fft_detect, jdetect.set_fused_fft_detect):
                        knob("auto")
    finally:
        jsafe.set_safe_mode(None)
    # "auto": the fused detect wherever it is supported
    assert detect.fused_fft_detect_enabled(nfft, **kw) == detect_kernel.supported(nfft, **kw)


def test_k4_wrapper_rejects_bad_inputs():
    plan = ct_plan.detect_plan(5120, **DET)
    x = torch.zeros(2, 5120)
    with pytest.raises(ValueError):  # not the plan's nfft
        detect_ct.detect_ct_partials(torch.zeros(2, 4096), torch.zeros(2, 4096), plan)
    with pytest.raises(TypeError):
        detect_ct.detect_ct_partials(x.double(), x.double(), plan)
    with pytest.raises(ValueError):  # not contiguous
        detect_ct.detect_ct_partials(torch.zeros(5120, 2).t(), torch.zeros(5120, 2).t(), plan)
    with pytest.raises(ValueError):
        detect.set_fused_detect("sometimes")
    with pytest.raises(ValueError):
        detect.set_fused_fft_detect("sometimes")
