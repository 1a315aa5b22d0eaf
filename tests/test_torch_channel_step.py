"""Kernel K8 parity: the port's plain megakernel vs the JAX one.

The JAX side runs ``split_complex.flagship_channel_step`` (the Pallas
megakernel ``channel_kernel.channel_step_partials`` in interpret mode, its
forward at the PHAT chain's "default" precision: float32 on the CPU) at
the sizes of ``tests/test_channel_kernel.py``: 3 channels × 4 receivers ×
4096 samples, max_lag 128 (nfft 5120). Tolerances are K1's and K2's:
noise floors within 1e-3 dB, segment scores within 1e-4 of the row's max
power with the candidate pattern and argmax exact outside float32-tied
segments, lag windows within 1e-4 of each pair's window max with the same
argmax.

The port's plain K8 equals its plain K1 → K2 (l2rx) composition exactly,
as ``test_megakernel_matches_composition`` holds the reference to: the
same functions on the same values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from radio_mapper_tpu import constants
from radio_mapper_tpu.ops import split_complex as jsc
from radio_mapper_tpu.ops.gcc_phat import pair_indices
from radio_mapper_tpu.ops.pallas import channel_kernel

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops import split_complex as sc
from radio_mapper_tpu_torch.ops.cuda import channel_step, gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_cuda import assert_partials_close, assert_windows_close

cap_cpu_threads()

DET = dict(
    sample_rate_hz=2_400_000.0,
    threshold_db=-70.0,
    min_distance_bins=constants.DEFAULT_PEAK_MIN_DISTANCE_BINS,
    dc_notch_hz=constants.DEFAULT_DC_NOTCH_HZ,
    confidence_floor=constants.DEFAULT_CONFIDENCE_FLOOR,
    snr_fullscale_db=constants.DEFAULT_SNR_FULLSCALE_DB,
    power_offset_db=40.0,
)
C, B, N, LAG = 3, 4, 4096, 128


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    re = (30 * rng.normal(size=(C, B, N))).astype(np.float32)
    im = (30 * rng.normal(size=(C, B, N))).astype(np.float32)
    t = np.arange(N)
    re[:, :, :] += (300 * np.cos(2 * np.pi * 0.1 * t)).astype(np.float32)  # one tone at every receiver
    im[:, :, :] += (300 * np.sin(2 * np.pi * 0.1 * t)).astype(np.float32)
    return re, im


def _plan(nfft):
    return ct_plan.detect_plan(nfft, **DET)


def test_plain_k8_matches_jax_megakernel():
    re, im = _inputs()
    pi, pj = pair_indices(B)
    nfft_ref, (s0, a0, nf0), w0 = jsc.flagship_channel_step(
        jnp.asarray(re), jnp.asarray(im), pi, pj, max_lag=LAG, eps=0.05, **DET
    )
    nfft = ct_plan.plan_nfft(N + LAG)
    assert nfft == nfft_ref == 5120
    plan = _plan(nfft)
    before = channel_step.launch_count
    got_nfft, (s, a, nf), w = sc.flagship_channel_step(
        torch.from_numpy(re), torch.from_numpy(im), pi, pj, max_lag=LAG, eps=0.05, plan=plan
    )
    assert channel_step.launch_count == before  # the CPU runs the plain version
    assert got_nfft == nfft
    assert tuple(s.shape) == (C, B, nfft // 8) and tuple(nf.shape) == (C, B)
    assert tuple(w.shape) == (C, len(pi), 2 * LAG + 1)
    assert_windows_close(w.numpy(), np.asarray(w0))
    np.testing.assert_array_equal(w.numpy().argmax(-1), np.asarray(w0).argmax(-1))

    # detect partials against the reference's, with the fragile segments
    # judged on the port's own spectra (the same float32 transform)
    (fr, fi, _), *_ = sc.receiver_spectra_ct_detect(
        torch.from_numpy(re), torch.from_numpy(im), max_lag=LAG, plan=plan
    )
    rows = lambda x: np.asarray(x).reshape(C * B, -1)
    assert_partials_close(
        (rows(s), rows(a), rows(nf)[:, 0]), (rows(s0), rows(a0), rows(nf0)[:, 0]), rows(fr), rows(fi), plan
    )


@pytest.mark.parametrize("gate", ["l2rx", "l1"])
def test_plain_k8_equals_k1_k2_composition(gate):
    """K8 (plain) == K1 (plain) → K2 (plain, l2rx on K1's row maxima),
    bit for bit; the megakernel keeps l2rx whatever the gate knob says."""
    re, im = (torch.from_numpy(a) for a in _inputs(5))
    pi, pj = pair_indices(B)
    plan = _plan(ct_plan.plan_nfft(N + LAG))
    (fr, fi, _), (s0, a0, nf0), rmax = sc.receiver_spectra_ct_detect(re, im, max_lag=LAG, plan=plan)
    w0 = gcc_pair.gcc_pair_lag_mags(fr, fi, rmax, pi, pj, max_lag=LAG, eps=0.05)
    gcc_pair.set_phat_gate(gate)
    try:
        _, (s, a, nf), w = sc.flagship_channel_step(re, im, pi, pj, max_lag=LAG, eps=0.05, plan=plan)
    finally:
        gcc_pair.set_phat_gate("l2rx")
    for x, y in ((s, s0), (a, a0), (nf, nf0), (w, w0)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("nfft,b,weighting", [
    (9216, 8, "phat"), (9216, 8, "cc"), (9216, 16, "phat"), (9216, 24, "phat"),
    (17408, 4, "phat"), (1024, 4, "phat"), (5120, 12, "phat"),
])
def test_supported_matches_reference(mode, nfft, b, weighting):
    kw = dict(min_distance_bins=10, noise_floor_stride=8, weighting=weighting)
    channel_kernel.set_mega_fused(mode)
    channel_step.set_mega_fused(mode)
    try:
        assert channel_step.supported(nfft, b, **kw) == channel_kernel.supported(nfft, b, **kw)
        assert not channel_step.supported(nfft, b, **dict(kw, noise_floor_stride=4))
    finally:
        channel_kernel.set_mega_fused("off")
        channel_step.set_mega_fused("off")
    assert not channel_step.supported(nfft, b, **kw)  # off by default
    with pytest.raises(ValueError):
        channel_step.set_mega_fused("sometimes")


def test_k8_wrapper_rejects_bad_inputs():
    plan = _plan(5120)
    pi, pj = pair_indices(4)
    x = torch.zeros(2, 4, 5120)
    with pytest.raises(ValueError):  # not the plan's nfft
        channel_step.channel_step_partials(x[..., :4096], x[..., :4096], pi, pj, plan, LAG)
    with pytest.raises(ValueError):  # pair index out of range
        channel_step.channel_step_partials(x, x, pi, pj + 1, plan, LAG)
    with pytest.raises(ValueError):  # lag window wider than half the transform
        channel_step.channel_step_partials(x, x, pi, pj, plan, 2560)
    with pytest.raises(ValueError):  # not contiguous
        y = torch.zeros(2, 5120, 4).transpose(1, 2)
        channel_step.channel_step_partials(y, y, pi, pj, plan, LAG)
    with pytest.raises(ValueError):  # the planner's nfft for this block is 5120, not 9216
        sc.flagship_channel_step(torch.zeros(2, 4, 4096), torch.zeros(2, 4, 4096), pi, pj,
                                 max_lag=LAG, eps=0.05, plan=_plan(9216))
