"""T1: the in-kernel top-K (``emit_topk``) of kernels K1 and K4, vs JAX.

With ``emit_topk = K`` the reference's ``detect_kernel._detect_body`` runs
K masked-argmax passes over its segment partials (the max, then the
lowest index holding it, as ``safe.top_k``) and writes a [rows, 128]
block of values and packed ``8·f + off`` instead of the F/8 partials;
``detect.set_combined_topk(True)`` sends the combined route (K1) through
it and ``peaks_from_ct_partials(kernel_topk=True)`` only unpacks.

Here the port's plain versions (``fft_detect.topk_plain`` inside K1's and
K4's) run against the Pallas kernels in interpret mode on the inputs of
``tests/test_fft_detect_fused.py::test_combined_kernel_in_kernel_topk_matches``
(5 rows of 9216), and ``step_split`` with the knob on against the
reference's combined-topk route and the port's own default route
(``tests/test_fft_detect_fused.py::test_pipeline_combined_topk_matches``'s
scene). Tolerances: packed indices and the peak set exactly; values
within 1e-4 of the row's max power and the floor within 1e-3 dB
(``tests/test_torch_fft_detect.py``: the packages' spectra, and even their
|X|² of the same spectra, round apart by ulps). The port's own
two routes (partials then the tail, and the top-K block then unpacking)
give the same peak set bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radio_mapper_tpu import sim as jsim
from radio_mapper_tpu.models import pipeline as jpipe
from radio_mapper_tpu.ops import detect as jdetect
from radio_mapper_tpu.ops.pallas import detect_kernel

from radio_mapper_tpu_torch import testing
from radio_mapper_tpu_torch.models import pipeline
from radio_mapper_tpu_torch.ops import ct_plan, detect, safe
from radio_mapper_tpu_torch.ops.cuda import detect_ct, fft_detect
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from test_fft_detect_fused import DET, _rows
from test_torch_routes import FUSED, _forced, _spy_wrappers

cap_cpu_threads()

K = 8
NFFT = 9216
TAIL = dict(sample_rate_hz=DET["sample_rate_hz"], max_peaks=K, power_offset_db=DET["power_offset_db"])
PEAK_FIELDS = ("bin_index", "freq_offset_hz", "power_db", "snr_db", "confidence", "valid", "noise_floor_db")


def _t(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _assert_topk_block(vals, packed, ref_vals, ref_packed, pmax):
    """The port's [rows, 128] block against the reference's [rows, K]:
    packed indices exactly, values within 1e-4 of the row's max power."""
    vals, packed = vals.numpy(), packed.numpy()
    assert vals.shape == packed.shape == (ref_vals.shape[0], 128)
    np.testing.assert_array_equal(vals[:, K:], 0.0)
    np.testing.assert_array_equal(packed[:, K:], 0.0)
    np.testing.assert_array_equal(packed[:, :K], ref_packed)
    np.testing.assert_array_equal(np.isfinite(vals[:, :K]), np.isfinite(ref_vals))
    fin = np.isfinite(ref_vals)
    assert fin.any()
    assert (np.abs(vals[:, :K] - ref_vals)[fin] <= 1e-4 * np.broadcast_to(pmax, fin.shape)[fin]).all()


def test_plain_k1_topk_matches_pallas_interpret():
    re, im = _rows(5, NFFT, seed=21)
    plan = ct_plan.detect_plan(NFFT, **DET)
    fr, fi, sv, av, nfv, rmax = (np.asarray(a) for a in detect_kernel.fft_detect_rows_ct(
        re, im, **DET, interpret=True, precision="default", emit_topk=K
    ))
    assert sv.shape == av.shape == (5, K)
    out = fft_detect.fft_detect_rows_ct(*_t(re, im), plan, emit_topk=K)
    _assert_topk_block(out[2], out[3], sv, av, rmax[:, None])
    np.testing.assert_allclose(out[4].numpy(), nfv, atol=1e-3, rtol=0)
    np.testing.assert_allclose(out[5].numpy(), rmax, rtol=1e-5)

    # the peak set: the in-kernel route equals the two-stage route (the
    # port's partials + its top-K tail) bit for bit, and the reference's
    base = fft_detect.fft_detect_rows_ct(*_t(re, im), plan)
    np.testing.assert_array_equal(out[0].numpy(), base[0].numpy())  # the spectra are untouched
    two_stage = detect.peaks_from_ct_partials(*base[2:5], nfft=NFFT, **TAIL)
    in_kernel = detect.peaks_from_ct_partials(*out[2:5], nfft=NFFT, **TAIL, kernel_topk=True)
    for f in PEAK_FIELDS:
        np.testing.assert_array_equal(getattr(in_kernel, f).numpy(), getattr(two_stage, f).numpy(), err_msg=f)
    ref = jdetect.peaks_from_ct_partials(sv, av, nfv, nfft=NFFT, **TAIL, kernel_topk=True)
    assert in_kernel.valid.any()
    np.testing.assert_array_equal(in_kernel.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(in_kernel.bin_index.numpy(), np.asarray(ref.bin_index))


def test_plain_k4_topk_matches_pallas_interpret_and_its_own_tail():
    """K4 on the reference's own spectra: packed indices equal the Pallas
    kernel's, values within 1e-4 of the row's max power (the two packages
    round |X|² apart by an ulp); and the block equals the partials followed
    by the port's tail (``safe.top_k``) bit for bit."""
    re, im = _rows(5, NFFT, seed=21)
    fr, fi, *_ = (np.asarray(a) for a in detect_kernel.fft_detect_rows_ct(
        re, im, **DET, interpret=True, precision="default"
    ))
    sv, av, nfv = (np.asarray(a) for a in detect_kernel.detect_ct_partials(
        fr, fi, **DET, interpret=True, emit_topk=K
    ))
    plan = ct_plan.detect_plan(NFFT, **DET)
    vals, packed, nf = detect_ct.detect_ct_partials(*_t(fr, fi), plan, emit_topk=K)
    pmax = (fr.astype(np.float64) ** 2 + fi.astype(np.float64) ** 2).max(axis=-1, keepdims=True)
    _assert_topk_block(vals, packed, sv, av, pmax)
    np.testing.assert_allclose(nf.numpy(), nfv, atol=1e-3, rtol=0)
    score, arg, _ = detect_ct.detect_ct_partials(*_t(fr, fi), plan)
    tv, tf = safe.top_k(score, K)
    np.testing.assert_array_equal(vals[:, :K].numpy(), tv.numpy())
    np.testing.assert_array_equal(packed[:, :K].numpy(), (8 * tf + torch.gather(arg, -1, tf)).numpy())


def test_topk_of_rows_without_candidates_matches_reference():
    """A confidence floor above 1 passes nothing: every pass picks segment
    0 (all −inf), as ``safe.top_k`` and the reference's kernel do."""
    re, im = _rows(3, NFFT, seed=22)
    det = dict(DET, confidence_floor=1.5)
    sv, av = (np.asarray(a) for a in detect_kernel.fft_detect_rows_ct(
        re, im, **det, interpret=True, precision="default", emit_topk=K
    )[2:4])
    out = fft_detect.fft_detect_rows_ct(*_t(re, im), ct_plan.detect_plan(NFFT, **det), emit_topk=K)
    assert np.isneginf(sv).all() and torch.isneginf(out[2][:, :K]).all()
    np.testing.assert_array_equal(out[3][:, :K].numpy(), av)
    peaks = detect.peaks_from_ct_partials(*out[2:5], nfft=NFFT, **TAIL, kernel_topk=True)
    assert not peaks.valid.any() and not peaks.bin_index.any()


@pytest.mark.parametrize("k", [0, 1, 128])
def test_emit_topk_range_is_the_reference_s(k):
    """0 is off; 1..128 fill one lane block; anything else raises, in K1
    and K4 alike (``detect_kernel._detect_plan``)."""
    re, im = _rows(2, 2048, seed=3)
    plan = ct_plan.detect_plan(2048, **DET)
    out = fft_detect.fft_detect_rows_ct(*_t(re, im), plan, emit_topk=k)
    assert out[2].shape == ((2, plan.segments) if k == 0 else (2, 128))
    assert detect_ct.detect_ct_partials(out[0], out[1], plan, emit_topk=k)[0].shape == out[2].shape
    for bad in (-1, 129):
        with pytest.raises(ValueError, match="emit_topk"):
            fft_detect.fft_detect_rows_ct(*_t(re, im), plan, emit_topk=bad)
        with pytest.raises(ValueError, match="emit_topk"):
            detect_ct.detect_ct_partials(out[0], out[1], plan, emit_topk=bad)


def test_detect_peaks_ct_kernel_topk_equals_the_two_stage_route():
    re, im = _rows(5, NFFT, seed=21)
    plan = ct_plan.detect_plan(NFFT, **DET)
    fr, fi = fft_detect.fft_detect_rows_ct(*_t(re, im), plan)[:2]
    kw = dict(DET, max_peaks=K)
    a = detect.detect_peaks_ct(fr, fi, **kw)
    b = detect.detect_peaks_ct(fr, fi, **kw, kernel_topk=True)
    for f in PEAK_FIELDS:
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f).numpy(), err_msg=f)


def test_step_split_with_combined_topk_matches_reference_and_default_route(monkeypatch):
    scen = jsim.default_scenario(signal="noise", bandwidth_hz=100e3, snr_db=15.0, seed=23)
    cap = jsim.synthesize(scen)
    arrays = [np.real(cap.iq).astype(np.float32), np.imag(cap.iq).astype(np.float32),
              np.asarray(cap.buoy_enu, np.float32)]
    jcfg = jpipe.PipelineConfig(
        num_buoys=arrays[0].shape[0], block_len=arrays[0].shape[-1],
        sample_rate_hz=scen.sample_rate_hz, max_lag=256, solver_iterations=10,
    )
    cfg = pipeline.PipelineConfig.from_dict(jcfg.__dict__)

    def jax_run():
        jdetect.set_combined_topk(True)
        try:
            return jpipe.TDOAPipeline(jcfg).step_split(*map(jnp.asarray, arrays))
        finally:
            jdetect.set_combined_topk(False)

    ref = _forced({}, 0, jax_run)
    port = lambda **kw: pipeline.TDOAPipeline(cfg, device="cpu").step_split(*map(torch.from_numpy, arrays), **kw)
    default = port()
    seen = []
    called = _spy_wrappers(monkeypatch)
    detect.set_combined_topk(True)
    try:
        topk = port(on_stage=seen.append)
    finally:
        detect.set_combined_topk(False)
    assert (seen, called) == FUSED
    assert topk.peaks.valid.any()
    for f in ("bin_index", "valid"):
        np.testing.assert_array_equal(getattr(topk.peaks, f).numpy(), np.asarray(getattr(ref.peaks, f)), err_msg=f)
    for f in PEAK_FIELDS:
        np.testing.assert_array_equal(getattr(topk.peaks, f).numpy(), getattr(default.peaks, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(topk.fix.position_enu.numpy(), default.fix.position_enu.numpy())


def test_topk_comparison_tolerates_rounding_and_flags_a_wrong_index():
    """``testing.topk_errors`` (the card tests' and ``chip_smoke.py``'s
    comparison of kernel and plain top-K blocks): spectra a rounding apart
    pass; a swapped packed index, a nonzero lane past K or a value off by
    more than 1e-4 of the row's max power is reported."""
    re, im = _rows(5, NFFT, seed=21)
    plan = ct_plan.detect_plan(NFFT, **DET)
    out = fft_detect.fft_detect_rows_ct(*_t(re, im), plan, emit_topk=K)
    near = fft_detect.fft_detect_rows_ct(*_t(re * np.float32(1 + 1e-7), im), plan, emit_topk=K)
    _, rel, bad, checked = testing.topk_errors(near[2:4], out[2:4], out[5], K)
    assert rel <= 1e-6 and bad == 0 and checked > 0.5
    swapped = out[3].clone()
    swapped[:, [0, 1]] = swapped[:, [1, 0]]
    assert testing.topk_errors((out[2], swapped), out[2:4], out[5], K)[2] >= 5
    spill = out[3].clone()
    spill[0, K] = 8.0
    assert testing.topk_errors((out[2], spill), out[2:4], out[5], K)[2] == 1
    off = out[2].clone()
    off[:, 0] += 1e-3 * out[5]
    assert testing.topk_errors((off, out[3]), out[2:4], out[5], K)[1] > 1e-4
