"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch with CUDA:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test here skips (a CUDA kernel has no CPU mode).
The input builders and comparisons are shared with the JAX parity tests
(``test_torch_fft_detect.py``, ``test_torch_gcc_pair.py``,
``test_torch_fft_rows.py``, ``test_torch_gcc_pairs.py``,
``test_torch_wideband.py``, ``test_torch_fft_natural.py``), so a kernel is held to the same tolerances
as its plain version is against JAX:

- K1 and K3 spectra within 1e-4 of the row's max |X|, in both designs
  (one block a row up to 24576; the long-row designs, K3 on thread-block
  clusters, at 33792, 34816, 58368, 66560, 87040 and 121856, and forced
  onto 5120-24576, where they equal the one-block outputs bit for bit;
  K1 at n1 = 128/256 one launch of its cluster design at every length,
  equal to the one-block K1 up to 24576 and to the cluster K3 → K4 above
  bit for bit, ``-k cluster_k1``; ``-k cluster`` runs the cluster designs
  of K3, K7 and K1 alone; at n1 = 384,
  640 and 896 the wide design, K1 in one launch and K3 its forward half,
  equal to the workspace K3 → K4 bit for bit at 52224, 58368, 101376,
  129024, 87040, 97280, 117760, 128000 and 121856, and at every planned
  length with these n1, ``-k wide_k1``); K1 ``row_max``
  within 1e-5 relative, ``noise_floor_db`` within 1e-3 dB (log10 differs
  by ulps between libraries), segment partials exact outside
  float32-tied segments (see :func:`fragile_segments`), scores within
  1e-4 of the row's max power;
- K2, K5 and K6 lag windows within 1e-4 of each pair's window max, with
  the same argmax, in every whitening mode (l2rx, l2, l1, "cc"), at every
  inner length of their warp FFT (n1 = 128; 256 at nfft 34816; the mixed
  radix 384, 640 and 896 at 52224/58368, 87040 and 121856);
- K4 on K1's spectra equal to K1's own partials and floor, bit for bit
  (the same device function on the same floats), and K4 vs its plain
  version as K1's partials; K1's spectra equal to K3's bit for bit (the
  same radix steps of ``ct_fft.cuh``), so K3 → K4 gives K1's partials;
- K8 equal, bit for bit, to K1 → K2 (l2rx) on the same rows (the same
  device functions in the same order; above 24576 its long design is
  that composition), and vs its plain version within K1's and K2's
  bounds;
- K1's and K4's top-K blocks (``emit_topk``) equal, bit for bit, to their
  own partials followed by the port's top-K tail (K1 one launch of its
  cluster or wide design, also equal to the parent's design, the
  one-block K1 or the long K3 → K4, ``-k emit_topk``), and close to the plain
  versions' (:func:`radio_mapper_tpu_torch.testing.topk_errors`: values
  within 1e-4 of the row's max power, packed indices equal outside
  float32 near-ties);
- K7 spectra within 1e-4 of the row's max |X|, in natural order;
- pipelines on the card vs the CPU: lags within 1e-3 samples, fixes
  within 0.5 m (the narrowband ELT scene: 1e-2 samples and 1 m, see its
  test); the buoy dwell's peaks and bandwidths exactly;
- the complex ``fft``/``ifft`` through K7 vs the plain four-step within
  1e-4 of the row's max |X|, the complex ``step`` and ``StreamingTDOA``
  (the emitter's subchannel) on the card vs the CPU (``-k complex``);
- the node side (``-k node``): ``IngestLoop`` on the card bit for bit
  equal to the direct step on the ring's bytes; the buoy's
  ``detect_block`` on the card equal to the CPU's, also fed by rtl_tcp
  (an in-process server on port 0);
- the multi-device layer (``-k parallel``): the EP step, the sharded
  split step and the sharded wideband step with their ranks on the card
  at world size 1 (NCCL) and 2 (two ranks on one card, gloo) vs ranks on
  the CPU running the same algorithm (the fused chain forced on): lags
  within 1e-3 samples and fixes within 0.5 m where the peaks stand clear;
  ``dryrun_multichip(2)`` on the card;
- the narrowband pair stage (``-k pair_fft``): K9's spectra within 1e-5
  of each row's max |X| of ``torch.fft.fft`` and of the plain version,
  the max pass within 1e-6, K10's windows within 1e-4 of each pair's
  window max (K2's budget) of its plain version, of a whitened
  ``torch.fft.ifft`` and of the four-step, the same argmax, lags within
  4.6e-5 samples (the bf16 PHAT forward's budget in ROADMAP's Facts:
  FP32 throughout does no worse) and PSR within 1e-3, at 135000 and
  17280; the narrowband ``step_split_uint8`` and the complex ``step``
  at those lengths running K9, the max pass and K10 once a call, card
  vs CPU as the other pipeline tests;
- the LM solve's one launch (``-k lm_kernel``): equal bit for bit to its
  numpy float32 emulation (``testing.lm_emulate``) at small shapes, and
  against the eager loop on the card, on the same set-up, no further from
  it than twice the loop's own spread between the CPU and the card (see
  :func:`_lm_compare`), in both layouts; a whole solve with nothing
  synchronising, and its span.
"""

import functools

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch import sim, solver
from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline
from radio_mapper_tpu_torch.models.wideband import WidebandConfig, WidebandTDOAPipeline
from radio_mapper_tpu_torch.ops import ct_plan, gcc_phat
from radio_mapper_tpu_torch.ops.cuda import (
    channel_step, detect_ct, fft_detect, fft_natural, fft_rows, gcc_pair, lm_solve, pair_fft,
)
from radio_mapper_tpu_torch import testing
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

DET = dict(
    sample_rate_hz=2_400_000.0,
    threshold_db=-70.0,
    min_distance_bins=10,
    dc_notch_hz=10_000.0,
    confidence_floor=0.3,
    snr_fullscale_db=20.0,
    power_offset_db=42.1,
)


def tone_rows(batch, nfft, seed, scale=40.0, n_valid=None):
    """Tone + noise float32 rows, zero-padded past ``n_valid`` like the pipeline."""
    rng = np.random.default_rng(seed)
    re = (scale * rng.normal(size=(batch, nfft))).astype(np.float32)
    im = (scale * rng.normal(size=(batch, nfft))).astype(np.float32)
    t = np.arange(nfft)
    for k, f in enumerate((137, 1031, 4099)):
        re[k % batch] += (400.0 * np.cos(2 * np.pi * f * t / nfft)).astype(np.float32)
        im[k % batch] += (400.0 * np.sin(2 * np.pi * f * t / nfft)).astype(np.float32)
    if n_valid is not None:
        re[:, n_valid:] = 0.0
        im[:, n_valid:] = 0.0
    return re, im


def correlated_spectra(c, b, nfft, seed):
    """CT-order spectra of delayed copies of one band-limited noise source
    plus independent noise (a real correlation peak per pair), and each
    row's max power."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(c, nfft)) + 1j * rng.normal(size=(c, nfft))
    f = np.fft.fftfreq(nfft)
    src_f = np.fft.fft(src) * (np.abs(f) < 0.2)
    delays = rng.uniform(-40, 40, size=(c, b))
    x = np.fft.ifft(src_f[:, None, :] * np.exp(-2j * np.pi * f * delays[..., None]))
    x = x + 0.5 * (rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape))
    spec = np.fft.fft(x)[..., ct_plan.ct_permutation(nfft)]  # natural → CT order
    sre = np.ascontiguousarray(spec.real, dtype=np.float32)
    sim_ = np.ascontiguousarray(spec.imag, dtype=np.float32)
    return sre, sim_, (sre**2 + sim_**2).max(axis=-1)


def fragile_segments(fr, fi, nf_db, plan, rel=1e-4):
    """Segments whose candidate decisions sit within float32 noise of a tie,
    from the reference spectra in float64: a bin within ``rel`` of the
    largest other power in its window, of the threshold, or of the
    confidence level (the noise floor's 1e-3 dB slack included)."""
    rows, n = fr.shape
    n1, n2, r = plan.n1, plan.n2, plan.radius
    p = fr.astype(np.float64) ** 2 + fi.astype(np.float64) ** 2
    nat = p.reshape(rows, n2, n1).transpose(0, 2, 1).reshape(rows, n)
    others = np.full_like(nat, -np.inf)
    for d in range(1, r + 1):
        for s in (d, -d):
            others = np.maximum(others, np.roll(nat, s, axis=-1))
    near = np.abs(nat - others) <= rel * nat
    near |= np.abs(nat - plan.thr_lin) <= rel * plan.thr_lin
    if plan.conf_cs is not None:
        conf = 10.0 ** ((nf_db.astype(np.float64) - plan.power_offset_db + plan.conf_cs) / 10.0)
        near |= np.abs(nat - conf[:, None]) <= 1e-3 * conf[:, None]
    ct = near.reshape(rows, n1, n2).transpose(0, 2, 1).reshape(rows, n)
    seg = ct_plan.SEGMENT
    return ct.reshape(rows, n2 // seg, seg, n1).any(axis=2).reshape(rows, n // seg)


def assert_spectra_close(out, ref):
    """Spectra ``(fr, fi)`` within 1e-4 of each row's max |X| of ``ref``."""
    fr, fi = (np.asarray(o) for o in ref)
    ofr, ofi = (np.asarray(o) for o in out)
    mag = np.sqrt(fr.astype(np.float64) ** 2 + fi.astype(np.float64) ** 2).max(axis=-1, keepdims=True)
    assert (np.abs(ofr - fr).max(axis=-1, keepdims=True) <= 1e-4 * mag).all()
    assert (np.abs(ofi - fi).max(axis=-1, keepdims=True) <= 1e-4 * mag).all()


def assert_partials_close(out, ref, fr, fi, plan):
    """Detect partials ``(seg_score, seg_arg, noise_floor_db)`` against the
    reference's, on rows whose CT-order spectra are ``(fr, fi)``."""
    score, arg, nf = (np.asarray(o) for o in ref)
    oscore, oarg, onf = (np.asarray(o) for o in out)
    fr, fi = np.asarray(fr), np.asarray(fi)
    np.testing.assert_allclose(onf, nf, atol=1e-3, rtol=0)
    fragile = fragile_segments(fr, fi, nf, plan)
    assert fragile.mean() < 0.01, fragile.mean()
    solid = ~fragile
    np.testing.assert_array_equal(np.isfinite(oscore)[solid], np.isfinite(score)[solid])
    both = solid & np.isfinite(score) & np.isfinite(oscore)
    assert both.sum() > 0
    np.testing.assert_array_equal(oarg[both], arg[both])
    pmax = (fr.astype(np.float64) ** 2 + fi.astype(np.float64) ** 2).max(axis=-1, keepdims=True)
    pmax = np.broadcast_to(pmax, score.shape)
    assert (np.abs(oscore[both] - score[both]) <= 1e-4 * pmax[both]).all()


def assert_k1_close(out, ref, plan):
    """K1 outputs ``out`` against reference outputs ``ref`` (numpy-able)."""
    fr, fi, *_, rmax = (np.asarray(o) for o in ref)
    assert_spectra_close(out[:2], (fr, fi))
    np.testing.assert_allclose(np.asarray(out[5]), rmax, rtol=1e-5)
    assert_partials_close(out[2:5], ref[2:5], fr, fi, plan)


def assert_windows_close(ours, ref):
    """Lag windows within 1e-4 of each pair's window max."""
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-4 * scale).all()


def pair_gate_scales(smax, pi, pj):
    """Per-pair l2rx gate scales s2 = smax_i·smax_j, ``[..., P]``."""
    return np.ascontiguousarray(smax[..., pi] * smax[..., pj], dtype=np.float32)


def some_pairs(b, p, seed):
    """A pair list that is not all pairs: ``p`` random (i, j), i ≠ j."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, b, size=p)
    j = (i + rng.integers(1, b, size=p)) % b
    return i.astype(np.int32), j.astype(np.int32)


def small_wideband_config(**kw):
    """The small config-4 shape of ``tests/test_wideband.py``."""
    base = dict(num_buoys=8, wide_rate_hz=4_096_000.0, num_subchannels=8,
                sub_block=1024, max_lag=64, solver_iterations=20)
    base.update(kw)
    return WidebandConfig(**base)


def wideband_scene(cfg, sub, seed, radius_m=9_000.0, emitter=(1_500.0, -2_200.0, 0.0), snr_db=25.0):
    """``sim.synthesize_wideband`` on a ring of buoys, emitter in
    subchannel ``sub``: ``(re, im, anchors, emitter)`` as numpy."""
    b = cfg.num_buoys
    ang = 2 * np.pi * np.arange(b) / b
    anchors = np.stack(
        [radius_m * np.cos(ang), radius_m * np.sin(ang), np.zeros(b)], axis=-1
    ).astype(np.float32)
    emitter = np.asarray(emitter, dtype=np.float64)
    re, im = sim.synthesize_wideband(
        cfg, active_subchannel=sub, anchors_enu=anchors, emitter_enu=emitter,
        snr_db=snr_db, seed=seed,
    )
    return re, im, anchors, emitter


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full FP32
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,n_valid", [(5120, 4096), (9216, 8192), (17408, 16384)])
def test_k1_kernel_matches_plain(cuda_device, nfft, n_valid):
    re, im = tone_rows(16, nfft, 11, n_valid=n_valid)
    plan = ct_plan.detect_plan(nfft, **DET)
    xr = torch.from_numpy(re).to(cuda_device)
    xi = torch.from_numpy(im).to(cuda_device)
    before = fft_detect.launch_count
    out = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    torch.cuda.synchronize()
    assert fft_detect.launch_count == before + 1
    ref = fft_detect.fft_detect_rows_ct_plain(xr, xi, plan)
    assert_k1_close([o.cpu() for o in out], [o.cpu() for o in ref], plan)


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,nfft,max_lag", [
    (2, 4, 9216, 256), (4, 8, 17408, 512), (2, 4, 34816, 512),
    (2, 4, 52224, 600), (1, 4, 87040, 600), (1, 3, 121856, 2048),
])
def test_k2_kernel_matches_plain(cuda_device, c, b, nfft, max_lag):
    """n1 = 128 (9216, 17408), n1 = 256 (34816 = 256·136) and the mixed
    radix 384, 640, 896 (52224, 87040, 121856 = n1·136): every inner
    length of the pair body's warp FFT."""
    sre, sim_, smax = (torch.from_numpy(a).to(cuda_device) for a in correlated_spectra(c, b, nfft, 5))
    pi, pj = gcc_phat.pair_indices(b)
    before = gcc_pair.launch_count
    out = gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, max_lag=max_lag)
    torch.cuda.synchronize()
    assert gcc_pair.launch_count == before + 1
    ref = gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, smax, pi, pj, max_lag=max_lag)
    assert_windows_close(out.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("gate,weighting", [("l2", "phat"), ("l1", "phat"), ("l2rx", "cc")])
def test_k2_modes_kernel_match_plain(cuda_device, gate, weighting):
    """K2's l2 and l1 gates (the pair's own maximum, a first pass) and "cc"."""
    sre, sim_, smax = (torch.from_numpy(a).to(cuda_device) for a in correlated_spectra(4, 8, 17408, 9))
    pi, pj = gcc_phat.pair_indices(8)
    gcc_pair.set_phat_gate(gate)
    try:
        before = gcc_pair.launch_count
        out = gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, max_lag=512, weighting=weighting)
        torch.cuda.synchronize()
        assert gcc_pair.launch_count == before + 1
        ref = gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, smax, pi, pj, max_lag=512, weighting=weighting)
    finally:
        gcc_pair.set_phat_gate("l2rx")
    assert_windows_close(out.cpu().numpy(), ref.cpu().numpy())
    np.testing.assert_array_equal(out.argmax(-1).cpu().numpy(), ref.argmax(-1).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", [5120, 9216, 16384, 17408, 24576])
def test_k1_spectra_equal_k3_and_k4_on_them_equals_k1(cuda_device, nfft):
    """K1 runs K3's steps (``ct_fft.cuh``) at every step-B tile (r = 5, 9,
    16, 17, 24): its spectra equal K3's bit for bit, and K4 on K3's spectra
    gives K1's partials and floor bit for bit."""
    re, im = tone_rows(16, nfft, 13, n_valid=nfft - nfft // 5)
    plan = ct_plan.detect_plan(nfft, **DET)
    xr = torch.from_numpy(re).to(cuda_device)
    xi = torch.from_numpy(im).to(cuda_device)
    fr, fi, score, arg, nf, _ = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    f3r, f3i = fft_rows.fft_rows_ct(xr, xi)
    out = detect_ct.detect_ct_partials(f3r, f3i, plan)
    torch.cuda.synchronize()
    for x, y in ((fr, f3r), (fi, f3i), *zip(out, (score, arg, nf))):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,n_valid", [(9216, 8192), (17408, 16384)])
def test_k4_kernel_matches_plain_and_k1(cuda_device, nfft, n_valid):
    re, im = tone_rows(16, nfft, 14, n_valid=n_valid)
    plan = ct_plan.detect_plan(nfft, **DET)
    xr = torch.from_numpy(re).to(cuda_device)
    xi = torch.from_numpy(im).to(cuda_device)
    fr, fi, score, arg, nf, rmax = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    before = detect_ct.launch_count
    out = detect_ct.detect_ct_partials(fr, fi, plan)
    torch.cuda.synchronize()
    assert detect_ct.launch_count == before + 1
    for a, b in zip(out, (score, arg, nf)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref = detect_ct.detect_ct_partials_plain(fr, fi, plan)
    host = lambda xs: [x.cpu() for x in xs]
    assert_k1_close(host((fr, fi, *out, rmax)), host((fr, fi, *ref, rmax)), plan)


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,nfft,max_lag", [
    (3, 4, 5120, 128), (4, 8, 17408, 512), (2, 3, 5120, 128), (2, 12, 5120, 64),
    (2, 11, 17408, 512), (1, 13, 17408, 512), (1, 16, 17408, 512),
])
def test_k8_kernel_matches_composition_and_plain(cuda_device, c, b, nfft, max_lag):
    """Clusters of 4 and 8 blocks (portable), 3 (not a power of two) and 12
    (non-portable, past 8); at nfft 17408, where each block holds 139 KB of
    shared memory and so one SM, 11 (the most receivers ``supported`` routes
    to K8: 55 pairs pad to 56 of 64), 13 and 16 (the wrapper's limit)."""
    re, im = tone_rows(c * b, nfft, 15, n_valid=nfft - max_lag - 512)
    plan = ct_plan.detect_plan(nfft, **DET)
    xr = torch.from_numpy(re).to(cuda_device)
    xi = torch.from_numpy(im).to(cuda_device)
    pi, pj = gcc_phat.pair_indices(b)
    before = channel_step.launch_count
    score, arg, nf, win = channel_step.channel_step_partials(
        xr.view(c, b, nfft), xi.view(c, b, nfft), pi, pj, plan, max_lag
    )
    torch.cuda.synchronize()
    assert channel_step.launch_count == before + 1
    fr, fi, s1, a1, nf1, rmax = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    w2 = gcc_pair.gcc_pair_lag_mags(fr.view(c, b, nfft), fi.view(c, b, nfft), rmax.view(c, b), pi, pj,
                                    max_lag=max_lag)
    for x, y in ((score.view(-1, nfft // 8), s1), (arg.view(-1, nfft // 8), a1), (nf.view(-1), nf1), (win, w2)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    ps, pa, pn, pw = channel_step.channel_step_partials_plain(
        xr.view(c, b, nfft), xi.view(c, b, nfft), pi, pj, plan, max_lag
    )
    assert_windows_close(win.cpu().numpy(), pw.cpu().numpy())
    np.testing.assert_allclose(nf.cpu().numpy(), pn.cpu().numpy(), atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["mega", "two-kernel"])
def test_pipeline_routes_on_card_match_cpu(cuda_device, route):
    """The scene of ``test_pipeline_on_card_matches_cpu`` on the mega route
    (K8 once) and the two-kernel route (K3, K4, K2 once each)."""
    from radio_mapper_tpu_torch.ops import detect

    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8)
    cap = sim.synthesize(scen)
    cfg = PipelineConfig(num_buoys=4, block_len=scen.block_len,
                         sample_rate_hz=scen.sample_rate_hz, max_lag=600, power_offset_db=40.0)
    host = [torch.from_numpy(a.astype(np.float32)) for a in (cap.iq.real, cap.iq.imag, cap.buoy_enu)]
    counters = lambda: (channel_step.launch_count, fft_rows.launch_count, detect_ct.launch_count,
                        gcc_pair.launch_count, fft_detect.launch_count)
    set_knob, default, want = {
        "mega": (channel_step.set_mega_fused, "off", (1, 0, 0, 0, 0)),
        "two-kernel": (detect.set_fused_fft_detect, "auto", (0, 1, 1, 1, 0)),
    }[route]
    set_knob("on" if route == "mega" else "off")
    try:
        cpu = TDOAPipeline(cfg, device="cpu").step_split(*host)
        before = counters()
        gpu = TDOAPipeline(cfg, device=cuda_device).step_split(*(a.to(cuda_device) for a in host))
        torch.cuda.synchronize()
    finally:
        set_knob(default)
    assert tuple(a - b for a, b in zip(counters(), before)) == want
    np.testing.assert_array_equal(gpu.peaks.bin_index.cpu().numpy(), cpu.peaks.bin_index.numpy())
    np.testing.assert_allclose(
        gpu.correlation.lag_samples.cpu().numpy(), cpu.correlation.lag_samples.numpy(), atol=1e-3
    )
    pos = gpu.fix.position_enu.cpu().numpy()
    np.testing.assert_allclose(pos, cpu.fix.position_enu.numpy(), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 50.0


@pytest.mark.cuda
def test_pipeline_on_card_matches_cpu(cuda_device):
    """A sim scene through the kernels on the card vs the plain versions on
    the CPU: lags within 1e-3 samples, fix within 0.5 m, under 50 m."""
    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8)
    cap = sim.synthesize(scen)
    cfg = PipelineConfig(num_buoys=4, block_len=scen.block_len,
                         sample_rate_hz=scen.sample_rate_hz, max_lag=600, power_offset_db=40.0)
    re = torch.from_numpy(cap.iq.real.astype(np.float32))
    im = torch.from_numpy(cap.iq.imag.astype(np.float32))
    anchors = torch.from_numpy(cap.buoy_enu.astype(np.float32))
    cpu = TDOAPipeline(cfg, device="cpu").step_split(re, im, anchors)
    k1, k2 = fft_detect.launch_count, gcc_pair.launch_count
    gpu = TDOAPipeline(cfg, device=cuda_device).step_split(
        re.to(cuda_device), im.to(cuda_device), anchors.to(cuda_device)
    )
    torch.cuda.synchronize()
    assert (fft_detect.launch_count, gcc_pair.launch_count) == (k1 + 1, k2 + 1)
    np.testing.assert_allclose(
        gpu.correlation.lag_samples.cpu().numpy(), cpu.correlation.lag_samples.numpy(), atol=1e-3
    )
    pos = gpu.fix.position_enu.cpu().numpy()
    np.testing.assert_allclose(pos, cpu.fix.position_enu.numpy(), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 50.0


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", [1152, 5120, 5760, 9216, 16384, 17408, 24576])
def test_k3_kernel_matches_plain(cuda_device, nfft):
    """K3 (ct_fft.cuh) at n = 128·n2, n2 = a·r: 1152 (a 1, r 9), 5120 (8, 5),
    5760 (1, 45: step B streamed), 9216 (8, 9), 16384 (8, 16), 17408 (8,
    17) and 24576 (8, 24)."""
    re, im = tone_rows(64, nfft, 12, n_valid=nfft - nfft // 5)
    xr = torch.from_numpy(re).to(cuda_device)
    xi = torch.from_numpy(im).to(cuda_device)
    before = fft_rows.launch_count
    out = fft_rows.fft_rows_ct(xr, xi)
    torch.cuda.synchronize()
    assert fft_rows.launch_count == before + 1
    ref = fft_rows.fft_rows_ct_plain(xr, xi)
    assert_spectra_close([o.cpu() for o in out], [o.cpu() for o in ref])


@pytest.mark.cuda
def test_k3_kernel_takes_long_rows_and_rejects_f3b(cuda_device):
    """32768 = 128·256 (256 KB a row) runs the long-row design, and so do
    the lengths that were fault F3b: 384·136, 640·136 and 896·136 (the
    row pass's mixed-radix warp FFT, P = 12, 20, 28), each within 1e-4
    of the row's max |X| of the plain version; a length with no CT split
    raises before any launch."""
    for nfft, rows in ((32768, 4), (52224, 4), (87040, 2), (121856, 2)):
        re, im = tone_rows(rows, nfft, 16, n_valid=nfft - 1024)
        xr, xi = torch.from_numpy(re).to(cuda_device), torch.from_numpy(im).to(cuda_device)
        key = "wide" if fft_rows.long_geometry(nfft).design == "wide" else "long"
        before, long_before = fft_rows.launch_count, fft_rows.design_counts[key]
        out = fft_rows.fft_rows_ct(xr, xi)
        torch.cuda.synchronize()
        assert (fft_rows.launch_count, fft_rows.design_counts[key]) == (before + 1, long_before + 1)
        assert_spectra_close([o.cpu() for o in out], [o.cpu() for o in fft_rows.fft_rows_ct_plain(xr, xi)])
    x = torch.zeros(2, 128 * 1031, device=cuda_device)  # n2 = 1031 > 1024 and prime: no split
    with pytest.raises(ValueError, match="factorization"):
        fft_rows.fft_rows_ct(x, x)
    assert fft_rows.launch_count == before + 1


# n1·n2 = 128·264, 256·136, 128·520, 384·152, 640·136, 896·136
LONG_SHAPES = [(16, 33792), (16, 34816), (8, 66560), (8, 58368), (4, 87040), (4, 121856)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,nfft", LONG_SHAPES)
def test_long_kernels_match_plain(cuda_device, rows, nfft):
    """K3, K4 and K1 on rows past one block's shared memory (the long-row
    designs, one launch of each wrapper; K1 its one-launch cluster design,
    at n1 = 128/256 the cluster K3's kernel with its detect half, at
    384/640/896 the wide design) vs their plain versions: K3's
    spectra within 1e-4 of the row's max |X|; K4 on K3's spectra and K1 as
    K1 is held; K1's outputs equal K3 → K4 on the same rows bit for bit."""
    re, im = tone_rows(rows, nfft, 17, n_valid=nfft - 1024)
    plan = ct_plan.detect_plan(nfft, **DET)
    xr, xi = torch.from_numpy(re).to(cuda_device), torch.from_numpy(im).to(cuda_device)
    wide = fft_rows.long_geometry(nfft).design == "wide"  # K1 one launch at every n1: the wide or cluster design
    counts = lambda: (fft_rows.design_counts["wide" if wide else "long"], fft_detect.design_counts["wide" if wide
                      else "cluster"], fft_rows.launch_count, detect_ct.launch_count, fft_detect.launch_count)
    before = counts()
    f3r, f3i = fft_rows.fft_rows_ct(xr, xi)
    k4 = detect_ct.detect_ct_partials(f3r, f3i, plan)
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1,) * 5
    host = lambda xs: [x.cpu() for x in xs]
    assert_spectra_close(host((f3r, f3i)), host(fft_rows.fft_rows_ct_plain(xr, xi)))
    p4 = detect_ct.detect_ct_partials_plain(f3r, f3i, plan)
    assert_partials_close(host(k4), host(p4), f3r.cpu(), f3i.cpu(), plan)
    assert_k1_close(host(k1), host(fft_detect.fft_detect_rows_ct_plain(xr, xi, plan)), plan)
    for x, y in zip(k1[:5], (f3r, f3i, *k4)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", [5120, 17408, 24576])
def test_long_design_forced_equals_one_block_design(cuda_device, nfft):
    """On lengths the one-block designs take, the long-row K3 and K1
    (called directly; K1 there is the cluster design, which the route
    takes too) give the one-block outputs (``fft_detect.block_detect``) bit
    for bit, and K4 (one design, column tiles) on the one-block K3's
    spectra gives the one-block K1's partials and floor bit for bit: the
    same per-value arithmetic (ct_fft.cuh's steps at r ≤ 24, ct_detect.cuh's
    parts), only the data movement differs."""
    re, im = tone_rows(16, nfft, 18, n_valid=nfft - nfft // 5)
    plan = ct_plan.detect_plan(nfft, **DET)
    xr, xi = torch.from_numpy(re).to(cuda_device), torch.from_numpy(im).to(cuda_device)
    assert fft_rows.geometry(nfft) == "block" and fft_detect.geometry(nfft) == "cluster"
    block = fft_detect.block_detect(xr, xi, plan)
    k3_block = fft_rows.fft_rows_ct(xr, xi)
    k4 = detect_ct.detect_ct_partials(*k3_block, plan)
    k3_long = fft_rows.fft_rows_ct_long(xr, xi)
    k1_long = fft_detect.fft_detect_rows_ct_long(xr, xi, plan)
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    torch.cuda.synchronize()
    for x, y in [*zip(k3_long, k3_block), *zip(k4, block[2:5]), *zip(k1_long, block), *zip(k1, block)]:
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,nfft", [(3, 25600), (3, 33792), (1, 34816), (3, 66560), (2, 115712), (1, 131072)])
def test_k3_cluster_matches_plain_at_each_cluster_size(cuda_device, rows, nfft):
    """The long K3's cluster design at n1 = 128 and 256, cluster sizes c =
    2, 4, 8, 32- and 16-column tiles and one or two blocks an SM (115712:
    one), on row counts off a multiple of anything, within 1e-4 of the
    row's max |X| of the plain version; the card runs such a cluster
    (cudaOccupancyMaxActiveClusters > 0) in the shared memory the
    geometry plans."""
    g = fft_rows.long_geometry(nfft)
    info = fft_rows.cluster_info(nfft)
    assert g.design == "cluster" and info["c"] == g.c and info["clusters"] > 0
    assert info["smem"] == fft_rows.cluster_smem(g.n1, g.n2, g.c)
    re, im = tone_rows(rows, nfft, 21, n_valid=nfft - 1024)
    xr, xi = torch.from_numpy(re).to(cuda_device), torch.from_numpy(im).to(cuda_device)
    out = fft_rows.fft_rows_ct_long(xr, xi)
    torch.cuda.synchronize()
    assert_spectra_close([o.cpu() for o in out], [o.cpu() for o in fft_rows.fft_rows_ct_plain(xr, xi)])


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", [17408, 24576])
def test_k3_cluster_forced_equals_one_block_k3(cuda_device, nfft):
    """Forced onto lengths the one-block K3 takes (c = 2, 64 columns a
    block), the cluster K3 gives the one-block spectra bit for bit, on 7
    rows."""
    re, im = tone_rows(7, nfft, 22, n_valid=nfft - nfft // 5)
    xr, xi = torch.from_numpy(re).to(cuda_device), torch.from_numpy(im).to(cuda_device)
    assert fft_rows.geometry(nfft) == "block" and fft_rows.long_geometry(nfft).c == 2
    for x, y in zip(fft_rows.fft_rows_ct_long(xr, xi), fft_rows.fft_rows_ct(xr, xi)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


# K1's lengths with n1 = 128 (up to 24576 the one-block K1 is the parent
# design: 2048 ... 24576) and the long rows at n1 = 128/256 (the cluster K3
# -> K4 before): c = 2, 4, 8, 32- and 16-column tiles, two blocks an SM and
# one (77824, 115712, 131072)
CLUSTER_K1_SHORT = [n for n in sorted({ct_plan.plan_nfft(m) for m in range(1024, 24_577, 1024)})
                    if ct_plan.ct_split(n)[1] >= DET["min_distance_bins"]]
CLUSTER_K1_LONG = [33_792, 34_816, 66_560, 25_600, 50_176, 77_824, 115_712, 131_072]


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", CLUSTER_K1_SHORT + CLUSTER_K1_LONG)
def test_cluster_k1_equals_the_parent_design(cuda_device, nfft):
    """K1 at n1 = 128/256 is one launch of the cluster design (the cluster
    K3's kernel with its detect half; ``design_counts["cluster"]``, no K3,
    no K4) and equals, bit for bit, the design it replaces: the one-block
    K1 up to 24576, the cluster K3 then K4 above — spectra, partials,
    floor and row max — on two tone rows and on :func:`flat_rows` (the
    zeros and the impulse fill one histogram bucket of the floor past the
    512 its selection ranks wherever the subsample holds more than 512
    values, so block 0 takes ``rm_det::bisect_floor``); held to the plain
    version as K1 is; the card runs the cluster at the c, shared memory
    and blocks an SM planned, at most 64 registers."""
    tr, ti = tone_rows(2, nfft, nfft % 97, n_valid=nfft - nfft // 8)
    fr_, fi_ = flat_rows(nfft)
    xr = torch.from_numpy(np.concatenate([tr, fr_])).to(cuda_device)
    xi = torch.from_numpy(np.concatenate([ti, fi_])).to(cuda_device)
    plan = ct_plan.detect_plan(nfft, **DET)
    g = fft_detect.cluster_geometry(nfft)
    assert fft_detect.geometry(nfft) == "cluster"
    counts = lambda: (fft_detect.design_counts["cluster"], fft_detect.launch_count, fft_rows.launch_count,
                      detect_ct.launch_count)
    before = counts()
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 0, 0)
    if nfft <= fft_detect.MAX_N:
        ref = fft_detect.block_detect(xr, xi, plan)
    else:
        f3 = fft_rows.long_rows(xr, xi)
        ref = (*f3, *detect_ct.launch(*f3, plan, row_max=True))
    for x, y in zip(k1, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    host = lambda xs: [x[:2].cpu() for x in xs]
    assert_k1_close(host(k1), host(fft_detect.fft_detect_rows_ct_plain(xr[:2], xi[:2], plan)), plan)
    if nfft // 8 > 512:
        sub = (k1[0] * k1[0] + k1[1] * k1[1]).view(-1, g.n2, g.n1)[2:4, ::8].cpu().numpy()  # CT rows k2 = 0 mod 8
        assert all(np.unique(x, return_counts=True)[1].max() > 512 for x in sub)
    info = fft_detect.cluster_info(nfft)
    assert info["c"] == g.c and info["clusters"] > 0 and info["registers"] <= 64
    assert info["smem"] == g.smem
    two = 2 * (g.smem + fft_rows.CLUSTER_DETECT_STATIC_BYTES + fft_rows.SMEM_RESERVED) <= fft_rows.SM_SMEM
    assert info["blocks"] == (2 if two else 1), info


# T1's shapes: n1 = 128 at c = 2, 4, 8, n1 = 256, and the wide design at 384, 640, 896
T1_SHAPES = [(16, 17_408), (8, 33_792), (8, 34_816), (4, 66_560), (4, 58_368), (4, 97_280), (4, 121_856)]
# the partials instantiations' shape on the card (PERF.md): registers, blocks an SM
T1_PARTIALS_INFO = {"cluster": (64, 2), 384: (64, 2), 640: (122, 1), 896: (128, 1)}


def t1_rows(nfft, rows):
    """Tone rows, a row with a tone at natural bin 3 (segment 0's offset
    3 where segment 0 is a candidate) and :func:`flat_rows`."""
    tr, ti = tone_rows(rows, nfft, 24, n_valid=nfft - 1024)
    t = np.arange(nfft)
    tr[-1] += (900.0 * np.cos(2 * np.pi * 3 * t / nfft)).astype(np.float32)
    ti[-1] += (900.0 * np.sin(2 * np.pi * 3 * t / nfft)).astype(np.float32)
    fr_, fi_ = flat_rows(nfft)
    return np.concatenate([tr, fr_]), np.concatenate([ti, fi_])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 128])
@pytest.mark.parametrize("rows,nfft", T1_SHAPES)
def test_cluster_k1_emit_topk_keeps_the_one_block_k1_and_k3_k4(cuda_device, rows, nfft, k):
    """``emit_topk`` (T1) is one launch of K1's cluster design (n1 =
    128/256, ``design_counts["cluster"]``) or wide design (384/640/896,
    ``["wide"]``), no K3 and no K4, and its ``[rows, 128]`` blocks, floor
    and row max equal, bit for bit, the design it replaces (the one-block
    K1 up to 24576, the long K3 then K4's top-K phase above) and the
    cluster K1's own partials followed by the port's top-K tail: on tone
    rows, :func:`flat_rows` and a tone at natural bin 3, with the
    flagship's detect plan, with a confidence floor no bin passes (1.5, an
    infinite threshold: every lane (-inf, segment 0's offset 0)) and with a
    floor 20 dB over the noise and no DC notch (segment 0's offset 3 fills
    the lanes past the tones' bins). The partials instantiations keep
    their registers and blocks an SM."""
    re, im = t1_rows(nfft, rows)
    xr, xi = torch.from_numpy(re).to(cuda_device), torch.from_numpy(im).to(cuda_device)
    n1 = ct_plan.ct_split(nfft)[0]
    design = "cluster" if n1 in fft_rows.CLUSTER_N1 else "wide"
    assert fft_detect.geometry(nfft, emit_topk=k) == design
    counts = lambda: (fft_detect.launch_count, fft_rows.launch_count, detect_ct.launch_count)
    for extra in ({}, {"confidence_floor": 1.5}, {"confidence_floor": 1.0, "dc_notch_hz": None}):
        plan = ct_plan.detect_plan(nfft, **{**DET, **extra})
        before, designs = counts(), dict(fft_detect.design_counts)
        t1 = fft_detect.fft_detect_rows_ct(xr, xi, plan, emit_topk=k)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(counts(), before)) == (1, 0, 0)
        ran = {d: v - designs[d] for d, v in fft_detect.design_counts.items() if v != designs[d]}
        assert ran == {design: 1}, ran
        if nfft <= fft_detect.MAX_N:
            parent = fft_detect.block_detect(xr, xi, plan, k)
        else:
            f3 = fft_rows.long_rows(xr, xi)
            parent = (*f3, *detect_ct.launch(*f3, plan, row_max=True, emit_topk=k))
        own = fft_detect.fft_detect_rows_ct(xr, xi, plan)
        tail = (*own[:2], *fft_detect.topk_plain(own[2], own[3], k), *own[4:])
        assert t1[2].shape == (xr.shape[0], fft_detect.TOPK_LANES)
        for x, y, z in zip(t1, parent, tail):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
            torch.testing.assert_close(x, z, rtol=0, atol=0)
        if extra:  # no candidate on the zeros and the impulse; the bin-3 row's last lane: a tone or offset 3
            assert torch.isinf(t1[2][rows:rows + 2, :k]).all() and not t1[3][rows:rows + 2, :k].any()
            if "dc_notch_hz" in extra:
                assert (t1[3][rows - 1, k - 1] == 3.0).item() or torch.isfinite(t1[2][rows - 1, k - 1]).item()
    if design == "cluster":
        g = fft_detect.cluster_geometry(nfft)
        info, t1_info = fft_detect.cluster_info(nfft), fft_detect.cluster_info(nfft, emit_topk=k)
        assert (info["c"], info["registers"], info["blocks"]) == (g.c, *T1_PARTIALS_INFO["cluster"]), info
    else:
        info, t1_info = fft_rows.wide_info(nfft), fft_rows.wide_info(nfft, topk=k)
        assert (info["registers"], info["blocks"]) == T1_PARTIALS_INFO[n1], info
    assert t1_info["clusters"] > 0 and t1_info["smem"] == info["smem"], t1_info


@pytest.mark.cuda
def test_k7_cluster_info(cuda_device):
    """K7's clusters of 2 and 4 blocks, 128 KiB each, fit the card."""
    for n, c in ((32768, 2), (65536, 4)):
        info = fft_natural.cluster_info(n)
        assert info == {"c": c, "smem": 131072, "clusters": info["clusters"]} and info["clusters"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "two-kernel"])
def test_pipeline_long_rows_on_card_match_cpu(cuda_device, route):
    """The phase-4 scene at block_len 32768 (nfft 33792, the long-row
    designs) on the default route (K1 one launch of its cluster design, no
    K4; K2) and the two-kernel route (K3, K4, K2) vs the CPU: detections
    equal, lags within 1e-3 samples, the fix within 0.5 m, under 50 m."""
    from radio_mapper_tpu_torch.ops import detect

    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8, block_len=32768)
    cap = sim.synthesize(scen)
    cfg = PipelineConfig(num_buoys=4, block_len=32768, sample_rate_hz=scen.sample_rate_hz, max_lag=600,
                         power_offset_db=40.0)
    host = [torch.from_numpy(a.astype(np.float32)) for a in (cap.iq.real, cap.iq.imag, cap.buoy_enu)]
    counters = lambda: (fft_detect.design_counts["cluster"], fft_rows.design_counts["long"],
                        detect_ct.launch_count, gcc_pair.launch_count)
    want = {"default": (1, 0, 0, 1), "two-kernel": (0, 1, 1, 1)}[route]
    detect.set_fused_fft_detect("off" if route == "two-kernel" else "auto")
    try:
        cpu = TDOAPipeline(cfg, device="cpu").step_split(*host)
        before = counters()
        gpu = TDOAPipeline(cfg, device=cuda_device).step_split(*(a.to(cuda_device) for a in host))
        torch.cuda.synchronize()
    finally:
        detect.set_fused_fft_detect("auto")
    assert tuple(a - b for a, b in zip(counters(), before)) == want
    np.testing.assert_array_equal(gpu.peaks.bin_index.cpu().numpy(), cpu.peaks.bin_index.numpy())
    np.testing.assert_allclose(
        gpu.correlation.lag_samples.cpu().numpy(), cpu.correlation.lag_samples.numpy(), atol=1e-3
    )
    pos = gpu.fix.position_enu.cpu().numpy()
    np.testing.assert_allclose(pos, cpu.fix.position_enu.numpy(), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 50.0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows,n,kind",
    [(1, 4096, "radix"), (8, 4096, "radix"), (13, 8192, "radix"), (40, 16384, "radix"),
     (1, 32768, "cluster"), (6, 32768, "cluster"), (3, 65536, "cluster"), (5, 65536, "cluster")],
)
def test_k7_kernel_matches_plain(cuda_device, rows, n, kind):
    """K7 vs its plain version, natural order: the one-launch radix design
    on 4096, 8192 and 16384 (the routed length), the cluster design on
    32768 and 65536 (clusters of 2 and 4 blocks); one row, and row counts
    off a multiple of 8."""
    re, im = tone_rows(rows, n, 13)
    xr = torch.from_numpy(re).to(cuda_device)
    xi = torch.from_numpy(im).to(cuda_device)
    assert fft_natural.design(n) == kind
    before = fft_natural.launch_count
    by_design = dict(fft_natural.design_counts)
    out = fft_natural.fft_rows(xr, xi)
    torch.cuda.synchronize()
    assert fft_natural.launch_count == before + 1
    assert fft_natural.design_counts == {**by_design, kind: by_design[kind] + 1}
    ref = fft_natural.fft_rows_plain(xr, xi)
    assert_spectra_close([o.cpu() for o in out], [o.cpu() for o in ref])
    # natural order: the tones of tone_rows sit at their own bins (137 alone
    # in row 0 from 3 rows up; all three tones there for one row)
    tones = {f % n for k, f in enumerate((137, 1031, 4099)) if k % rows == 0}
    assert 137 in tones
    assert set(out[0][0].abs().topk(len(tones)).indices.tolist()) == tones


@pytest.mark.cuda
def test_k7_kernel_rejects_unsupported_input(cuda_device):
    x = torch.zeros(2, 17280, device=cuda_device)  # 135·128: not a power of two, factors not multiples of 64
    before = fft_natural.launch_count
    with pytest.raises(ValueError):
        fft_natural.fft_rows(x, x)
    assert fft_natural.launch_count == before
    y = torch.zeros(16384, 2, device=cuda_device).t()
    with pytest.raises(ValueError):  # not contiguous
        fft_natural.fft_rows(y, y)
    with pytest.raises(TypeError):
        fft_natural.fft_rows(x.double(), x.double())


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,nfft,max_lag,pairs", [
    (3, 8, 5120, 128, None), (2, 12, 2048, 64, 37), (2, 6, 34816, 512, None),
    (1, 8, 58368, 600, None), (1, 4, 121856, 600, None),
])
def test_k5_kernel_matches_plain(cuda_device, m, b, nfft, max_lag, pairs):
    sre, sim_, smax = correlated_spectra(m, b, nfft, 6)
    pi, pj = gcc_phat.pair_indices(b) if pairs is None else some_pairs(b, pairs, 6)
    s2 = torch.from_numpy(pair_gate_scales(smax, pi, pj)).to(cuda_device)
    sre, sim_ = (torch.from_numpy(a).to(cuda_device) for a in (sre, sim_))
    before = gcc_pair.onehot_launch_count
    out = gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim_, pi, pj, max_lag=max_lag, s2=s2)
    torch.cuda.synchronize()
    assert gcc_pair.onehot_launch_count == before + 1
    ref = gcc_pair.gcc_pairs_onehot_lag_mags_plain(sre, sim_, pi, pj, max_lag=max_lag, s2=s2)
    assert out.shape == (m, len(pi), 2 * max_lag + 1)
    assert_windows_close(out.cpu().numpy(), ref.cpu().numpy())
    np.testing.assert_array_equal(out.argmax(-1).cpu().numpy(), ref.argmax(-1).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("b,nfft,max_lag", [(8, 5120, 128), (5, 34816, 512), (4, 87040, 600)])
def test_k6_kernel_matches_plain_and_k5(cuda_device, b, nfft, max_lag):
    sre, sim_, smax = correlated_spectra(1, b, nfft, 7)
    pi, pj = gcc_phat.pair_indices(b)
    s2 = torch.from_numpy(pair_gate_scales(smax[0], pi, pj)).to(cuda_device)
    sre, sim_ = (torch.from_numpy(a[0]).to(cuda_device) for a in (sre, sim_))
    rows = [x[torch.as_tensor(idx, dtype=torch.int64, device=cuda_device)].contiguous()
            for idx in (pi, pj) for x in (sre, sim_)]
    xre, xim, yre, yim = rows
    before = gcc_pair.rows_launch_count
    out = gcc_pair.gcc_rows_lag_mags(xre, xim, yre, yim, max_lag=max_lag, s2=s2)
    torch.cuda.synchronize()
    assert gcc_pair.rows_launch_count == before + 1
    ref = gcc_pair.gcc_rows_lag_mags_plain(xre, xim, yre, yim, max_lag=max_lag, s2=s2)
    assert_windows_close(out.cpu().numpy(), ref.cpu().numpy())
    k5 = gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim_, pi, pj, max_lag=max_lag, s2=s2)
    assert_windows_close(out.cpu().numpy(), k5.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["on", "off"])
def test_wideband_on_card_matches_cpu(cuda_device, route):
    """The small config-4 scene through K3 + K5 (or K6) on the card vs the
    plain versions on the CPU."""
    cfg = small_wideband_config()
    sub = 3
    re, im, anchors, emitter = wideband_scene(cfg, sub, seed=1)
    host = [torch.from_numpy(a) for a in (re, im, anchors)]
    cpu = WidebandTDOAPipeline(cfg, device="cpu").step_split(*host)
    counts = (fft_rows.launch_count, gcc_pair.onehot_launch_count, gcc_pair.rows_launch_count)
    gcc_pair.set_onehot_pairs(route)
    try:
        gpu = WidebandTDOAPipeline(cfg, device=cuda_device).step_split(*(a.to(cuda_device) for a in host))
        torch.cuda.synchronize()
    finally:
        gcc_pair.set_onehot_pairs("auto")
    m = cfg.num_subchannels
    want = (1, 1, 0) if route == "on" else (1, 0, m)
    got = (fft_rows.launch_count, gcc_pair.onehot_launch_count, gcc_pair.rows_launch_count)
    assert tuple(g - c for g, c in zip(got, counts)) == want
    np.testing.assert_allclose(gpu.lags[sub].cpu().numpy(), cpu.lags[sub].numpy(), atol=1e-3)
    np.testing.assert_allclose(gpu.weights[sub].cpu().numpy(), cpu.weights[sub].numpy(), atol=1e-3)
    fix = gpu.fixes_enu[sub].cpu().numpy()
    np.testing.assert_allclose(fix, cpu.fixes_enu[sub].numpy(), atol=0.5)
    assert np.linalg.norm(fix[:2] - emitter[:2]) < 300.0


@pytest.mark.cuda
@pytest.mark.parametrize("rows,nfft", [(16, 17408), (8, 33792), (8, 58368)])
def test_topk_kernels_match_their_partials_tail_and_plain(cuda_device, rows, nfft):
    """K1 (one launch of its cluster design at 17408 and 33792, its wide
    design at 58368) and K4 with ``emit_topk = 8``: bit for bit the kernels' own
    partials followed by the port's tail (``fft_detect.topk_plain``), the
    spectra, floor and row max untouched; close to the plain versions'."""
    re, im = tone_rows(rows, nfft, 19, n_valid=nfft - 1024)
    plan = ct_plan.detect_plan(nfft, **DET)
    xr, xi = torch.from_numpy(re).to(cuda_device), torch.from_numpy(im).to(cuda_device)
    counts = lambda: (fft_detect.launch_count, detect_ct.launch_count)
    before = counts()
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, plan, emit_topk=8)
    k4 = detect_ct.detect_ct_partials(k1[0], k1[1], plan, emit_topk=8)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1)
    base = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    tail = fft_detect.topk_plain(base[2], base[3], 8)
    for x, y in [*zip(k1[:2], base[:2]), *zip(k1[2:4], tail), *zip(k1[4:], base[4:]), *zip(k4[:2], tail),
                 (k4[2], base[4])]:
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    plain = fft_detect.fft_detect_rows_ct_plain(xr, xi, plan, emit_topk=8)
    p4 = detect_ct.detect_ct_partials_plain(k1[0], k1[1], plan, emit_topk=8)
    for out, ref in ((k1[2:4], plain[2:4]), (k4[:2], p4[:2])):
        _, rel, bad, checked = testing.topk_errors(out, ref, plain[5], 8)
        assert rel <= 1e-4 and bad == 0 and checked > 0.5, (rel, bad, checked)


@pytest.mark.cuda
@pytest.mark.parametrize("c,b,nfft,max_lag", [(2, 8, 58368, 600), (1, 4, 121856, 600), (1, 4, 33792, 600),
                                               (16, 8, 58368, 600)])
def test_k8_long_design_equals_composition_and_plain(cuda_device, c, b, nfft, max_lag):
    """K8 above 24576: the long K1 (its one-launch cluster design at every
    n1: the wide design at 384/640/896, the cluster K3's kernel with its
    detect half at 128/256) and K2 (l2rx), counted as one K8 launch, equal
    to K1 → K2 bit for bit."""
    re, im = tone_rows(c * b, nfft, 20, n_valid=nfft - max_lag - 512)
    plan = ct_plan.detect_plan(nfft, **DET)
    xr, xi = torch.from_numpy(re).to(cuda_device), torch.from_numpy(im).to(cuda_device)
    pi, pj = gcc_phat.pair_indices(b)
    assert channel_step.geometry(nfft) == "long"
    counts = lambda: (channel_step.launch_count, channel_step.design_counts["long"], fft_detect.launch_count,
                      fft_rows.launch_count, detect_ct.launch_count, gcc_pair.launch_count)
    before = counts()
    score, arg, nf, win = channel_step.channel_step_partials(
        xr.view(c, b, nfft), xi.view(c, b, nfft), pi, pj, plan, max_lag
    )
    torch.cuda.synchronize()
    assert tuple(a - b_ for a, b_ in zip(counts(), before)) == (1, 1, 0, 0, 0, 0)
    fr, fi, s1, a1, nf1, rmax = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    w2 = gcc_pair.gcc_pair_lag_mags(fr.view(c, b, nfft), fi.view(c, b, nfft), rmax.view(c, b), pi, pj,
                                    max_lag=max_lag)
    for x, y in ((score.view(-1, nfft // 8), s1), (arg.view(-1, nfft // 8), a1), (nf.view(-1), nf1), (win, w2)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    ps, pa, pn, pw = channel_step.channel_step_partials_plain(
        xr.view(c, b, nfft), xi.view(c, b, nfft), pi, pj, plan, max_lag
    )
    assert_windows_close(win.cpu().numpy(), pw.cpu().numpy())
    np.testing.assert_allclose(nf.cpu().numpy(), pn.cpu().numpy(), atol=1e-3, rtol=0)


# the wide design's lengths: n1 = 384, r = 17, 19 (the flagship at block_len
# 57344), 33 (one block an SM) and 42 (the longest planned, 129024); n1 =
# 640, r = 17, 19 (the flagship at block_len 96000), 23, 25; n1 = 896, r = 17
WIDE_K1_SHAPES = [(8, 52224), (8, 58368), (4, 101376), (2, 129024),
                  (4, 87040), (4, 97280), (2, 117760), (2, 128000), (2, 121856)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,nfft", WIDE_K1_SHAPES)
def test_wide_k1_and_k3_equal_workspace_k3_k4(cuda_device, rows, nfft):
    """K1 at n1 = 384, 640, 896 is one launch of the wide design and K3 the same
    kernel without its detect half (``design_counts["wide"]``, no K4): the
    spectra, partials, floor and row max equal the workspace K3 → K4's
    (``fft_rows.workspace_rows``, the parent design) bit for bit and are
    held to the plain version as K1 is; with ``emit_topk = 8`` K1 is one
    launch of the wide design too (its top-K instantiation), equal to its
    own partials followed by the port's top-K tail and to the workspace
    K3 → K4's top-K phase; the card runs the cluster (active clusters >
    0) at the blocks an SM, shared memory and registers planned."""
    re, im = tone_rows(rows, nfft, 23, n_valid=nfft - 1024)
    plan = ct_plan.detect_plan(nfft, **DET)
    xr, xi = torch.from_numpy(re).to(cuda_device), torch.from_numpy(im).to(cuda_device)
    g = fft_rows.long_geometry(nfft)
    assert g.design == "wide" and fft_detect.geometry(nfft) == "wide" and fft_rows.geometry(nfft) == "long"
    counts = lambda: (fft_detect.design_counts["wide"], fft_rows.design_counts["wide"], fft_detect.launch_count,
                      fft_rows.launch_count, detect_ct.launch_count)
    before = counts()
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    k3 = fft_rows.fft_rows_ct(xr, xi)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1, 0)
    w3 = fft_rows.workspace_rows(xr, xi)
    w4 = detect_ct.launch(*w3, plan, row_max=True)
    for x, y in [*zip(k3, w3), *zip(k1, (*w3, *w4))]:
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    host = lambda xs: [x.cpu() for x in xs]
    assert_k1_close(host(k1), host(fft_detect.fft_detect_rows_ct_plain(xr, xi, plan)), plan)
    t1_before = (fft_detect.design_counts["wide"], fft_detect.design_counts["long"])
    t1 = fft_detect.fft_detect_rows_ct(xr, xi, plan, emit_topk=8)
    torch.cuda.synchronize()
    assert (fft_detect.design_counts["wide"], fft_detect.design_counts["long"]) == (t1_before[0] + 1, t1_before[1])
    w4t = detect_ct.launch(*w3, plan, row_max=True, emit_topk=8)
    for x, y, z in zip(t1, (*k1[:2], *fft_detect.topk_plain(k1[2], k1[3], 8), *k1[4:]), (*w3, *w4t)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        torch.testing.assert_close(x, z, rtol=0, atol=0)
    for detect in (True, False):
        info = fft_rows.wide_info(nfft, detect)
        assert info["c"] == 8 and info["clusters"] > 0
        # the launch bounds' register budget: two blocks' worth, or one
        assert info["registers"] <= 65_536 // (info["min_blocks"] * fft_rows.WIDE_THREADS)
        assert info["smem"] == fft_rows.wide_smem(g.n1, g.n2, detect)
        # two blocks an SM wherever two fit its shared memory: the launch bounds allow them
        assert info["blocks"] == fft_rows.wide_blocks(g.n1, g.n2, detect) <= info["min_blocks"], (detect, info)


# every planned length whose split has n1 = 384, 640 or 896: the wide design's 23
WIDE_PLANNED = sorted({n for n in map(ct_plan.plan_nfft, range(1024, 131_073, 1024))
                       if ct_plan.ct_split(n)[0] in (384, 640, 896)})


def flat_rows(nfft):
    """Three rows of a receiver with no signal: zeros and an impulse, whose
    powers are all equal, and a constant offset (a DC bin, the rest zero
    or nearly)."""
    re, im = np.zeros((3, nfft), np.float32), np.zeros((3, nfft), np.float32)
    re[1, 0], re[2], im[2] = 1.0, 0.25, -0.5
    return re, im


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", WIDE_PLANNED)
def test_wide_k1_and_k3_run_at_every_planned_length(cuda_device, nfft):
    """At each of the 23 planned n1 = 384, 640, 896 lengths, K1 and K3 are one launch
    of the wide design each and equal the workspace K3 → K4 bit for bit, on
    two tone rows and on :func:`flat_rows`: on the zeros and the impulse the
    floor's values fill one histogram bucket past the 512 its selection
    ranks, so block 0 takes ``rm_det::bisect_floor``."""
    assert len(WIDE_PLANNED) == 23
    tr, ti = tone_rows(2, nfft, nfft % 89, n_valid=nfft - 1024)
    fr_, fi_ = flat_rows(nfft)
    xr = torch.from_numpy(np.concatenate([tr, fr_])).to(cuda_device)
    xi = torch.from_numpy(np.concatenate([ti, fi_])).to(cuda_device)
    plan = ct_plan.detect_plan(nfft, **DET)
    counts = lambda: (fft_detect.design_counts["wide"], fft_rows.design_counts["wide"], detect_ct.launch_count)
    before = counts()
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    k3 = fft_rows.fft_rows_ct(xr, xi)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 0)
    w3 = fft_rows.workspace_rows(xr, xi)
    w4 = detect_ct.launch(*w3, plan, row_max=True)
    for x, y in [*zip(k3, w3), *zip(k1, (*w3, *w4))]:
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    n1, n2 = ct_plan.ct_split(nfft)
    sub = (w3[0] * w3[0] + w3[1] * w3[1]).view(-1, n2, n1)[2:4, ::8].cpu().numpy()  # CT rows k2 = 0 mod 8
    assert all(np.unique(x, return_counts=True)[1].max() > 512 for x in sub)


@functools.lru_cache(maxsize=4)
def _wide_spectra(c, b, nfft):
    return correlated_spectra(c, b, nfft, nfft % 83)


WIDE_CASES = [("K2", 2, 8, 58_368), ("K2", 1, 4, 87_040), ("K2", 1, 4, 121_856), ("K5", 1, 64, 58_368),
              ("K6", 1, 64, 58_368), ("K2", 4, 8, 17_408), ("K2", 2, 4, 34_816), ("K5", 1, 64, 5_120),
              ("K6", 1, 64, 5_120)]


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["l2rx", "l2", "l1", "none"])
@pytest.mark.parametrize("kind,c,b,nfft", WIDE_CASES)
def test_wide_pair_kernels_match_plain_at_every_gate(cuda_device, kind, c, b, nfft, gate):
    """The pair body (n1 = 384, 640, 896, and 128, 256 at 17408, 34816
    and 5120; tiles of two pairs in K2, the fold on tensor cores in the
    3xTF32 split, bulk copies) against the plain versions at max_lag 600
    (one block of n-tiles at n1 = 128 and up) and 2048 (two blocks along
    the window): 1e-4 of the window max, the same argmax. K5 and K6 on
    the 2016 pairs of 64 receivers at 58368 and 5120."""
    sre, sim_, smax = _wide_spectra(c, b, nfft)
    pi, pj = gcc_phat.pair_indices(b)
    dev = cuda_device
    sre, sim_ = torch.from_numpy(sre).to(dev), torch.from_numpy(sim_).to(dev)
    weighting = "cc" if gate == "none" else "phat"
    if kind == "K2":
        sm = torch.from_numpy(smax).to(dev) if gate == "l2rx" else None
        run = lambda lag: gcc_pair.gcc_pair_lag_mags(sre, sim_, sm, pi, pj, max_lag=lag, weighting=weighting)
        plain = lambda lag: gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, sm, pi, pj, max_lag=lag, weighting=weighting)
        count = lambda: gcc_pair.launch_count
    else:
        s2 = torch.from_numpy(pair_gate_scales(smax, pi, pj)).to(dev) if gate == "l2rx" else None
        if kind == "K5":
            run = lambda lag: gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim_, pi, pj, max_lag=lag, weighting=weighting,
                                                                 s2=s2)
            plain = lambda lag: gcc_pair.gcc_pairs_onehot_lag_mags_plain(sre, sim_, pi, pj, max_lag=lag,
                                                                         weighting=weighting, s2=s2)
            count = lambda: gcc_pair.onehot_launch_count
        else:
            rows = [x[0][torch.as_tensor(idx, dtype=torch.int64, device=dev)].contiguous()
                    for idx in (pi, pj) for x in (sre, sim_)]
            s6 = None if s2 is None else s2[0].contiguous()
            run = lambda lag: gcc_pair.gcc_rows_lag_mags(*rows, max_lag=lag, weighting=weighting, s2=s6)
            plain = lambda lag: gcc_pair.gcc_rows_lag_mags_plain(*rows, max_lag=lag, weighting=weighting, s2=s6)
            count = lambda: gcc_pair.rows_launch_count
    assert ct_plan.ct_split(nfft)[0] in gcc_pair.PAIR_N1
    if gate in ("l2", "l1"):
        gcc_pair.set_phat_gate(gate)
    try:
        for lag in (600, 2048):
            before = count()
            out = run(lag)
            torch.cuda.synchronize()
            assert count() == before + 1
            ref = plain(lag)
            assert out.shape == ref.shape and out.shape[-1] == 2 * lag + 1
            assert_windows_close(out.cpu().numpy(), ref.cpu().numpy())
            np.testing.assert_array_equal(out.argmax(-1).cpu().numpy(), ref.argmax(-1).cpu().numpy())
    finally:
        gcc_pair.set_phat_gate("l2rx")


@pytest.mark.cuda
def test_wide_kernels_one_a_length_no_spills_two_blocks_at_384(cuda_device):
    """K2, K5 (the tile kernel, the gate per pair) and K6 each have a
    kernel for every inner length n1 = 128, 256, 384, 640 and 896 alone
    with no local memory (no spills, in the card's attributes and in the
    build's -Xptxas -v report), n1 = 128, 256 and 384 two 256-thread
    blocks an SM at their launches' shared memory on the main paths'
    shapes, 640 and 896 at least one."""
    from radio_mapper_tpu_torch.ops.cuda import build

    shapes = {128: ((136, 512), (40, 128)), 256: ((136, 512),), 384: ((152, 600),), 640: ((152, 600),),
              896: ((136, 600),)}  # the main paths' (n2, max_lag): 17408, 5120, 34816, 58368, 97280, 121856
    for kind, pairs in (("K2", 2), ("K5", gcc_pair.TILE_PAIRS), ("K6", 1)):
        for n1 in gcc_pair.PAIR_N1:
            for n2, lag in shapes[n1]:
                plan = gcc_pair.wide_plan(n1, n2, -(-lag // n1), lag // n1 + 1, pairs)
                info = gcc_pair.wide_info(kind, n1, plan.smem)
                assert info["local_bytes"] == 0, (kind, n1, info)
                assert info["blocks"] >= (2 if n1 <= 384 else 1), (kind, n1, info)
    names = [f"gcc_pair_tile_kernel<{n1}, {s2}>" for n1 in gcc_pair.PAIR_N1 for s2 in (0, 1)]  # K2, K5
    names += [f"gcc_rows_kernel<{n1}>" for n1 in gcc_pair.PAIR_N1]  # K6
    body = [r for r in build.ptxas_report(build.build_log()) if r["kernel"].startswith("gcc_")]
    assert sorted(r["kernel"] for r in body) == sorted(names)
    assert all(r["spill_stores"] == r["spill_loads"] == 0 for r in body), body


# SHA-256 digests (first 16 hex digits) of the n1 = 128/256 pair kernels'
# outputs in ``tools/forward_times.pair_digests``, as the pair body with
# bulk copies and the 3xTF32 fold on tensor cores gives them on an H100
# (the fold's TF32 split and its sums by k-step changed the bits of the
# earlier CUDA-core body; the 1e-4 and argmax checks against the plain
# versions hold them still)
NARROW_PAIR_DIGESTS = {"K2": "87400cfe3c255192", "K5": "ce0ff217327a89b6", "K6": "e6b63b4618fd0b8f",
                       "K8": "610ed64d82a911f7"}


@pytest.mark.cuda
def test_narrow_pair_kernels_keep_their_digests(cuda_device):
    """K2 (every gate), K5, K6 and K8 at n1 = 128 (5120, 17408) and 256
    (34816) give the outputs pinned above: any later change to the pair
    body that moves a bit shows here."""
    from radio_mapper_tpu_torch.tools import forward_times

    assert forward_times.pair_digests(cuda_device) == NARROW_PAIR_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "two-kernel", "mega", "combined-topk"])
def test_pipeline_mixed_radix_rows_on_card_match_cpu(cuda_device, route):
    """The phase-4 scene at block_len 57344 (nfft 58368 = 384·152: the
    long K3's mixed-radix row pass, K2's mixed-radix pair body) on the
    default route (K1), the two-kernel route (K3, K4), the mega route (K8's
    long design) and the default route with the in-kernel top-K, vs the
    CPU on the same route: detections equal, lags within 1e-3 samples, the
    fix within 0.5 m, under 50 m."""
    from radio_mapper_tpu_torch.ops import detect

    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8, block_len=57344)
    cap = sim.synthesize(scen)
    cfg = PipelineConfig(num_buoys=4, block_len=57344, sample_rate_hz=scen.sample_rate_hz, max_lag=600,
                         power_offset_db=40.0)
    host = [torch.from_numpy(a.astype(np.float32)) for a in (cap.iq.real, cap.iq.imag, cap.buoy_enu)]
    counters = lambda: (fft_detect.launch_count, fft_rows.launch_count, detect_ct.launch_count,
                        gcc_pair.launch_count, channel_step.design_counts["long"])
    knob, on, off, want = {
        "default": (detect.set_fused_fft_detect, "auto", "auto", (1, 0, 0, 1, 0)),
        "two-kernel": (detect.set_fused_fft_detect, "off", "auto", (0, 1, 1, 1, 0)),
        "mega": (channel_step.set_mega_fused, "on", "off", (0, 0, 0, 0, 1)),
        "combined-topk": (detect.set_combined_topk, True, False, (1, 0, 0, 1, 0)),
    }[route]
    knob(on)
    try:
        cpu = TDOAPipeline(cfg, device="cpu").step_split(*host)
        before = counters()
        gpu = TDOAPipeline(cfg, device=cuda_device).step_split(*(a.to(cuda_device) for a in host))
        torch.cuda.synchronize()
    finally:
        knob(off)
    assert tuple(a - b for a, b in zip(counters(), before)) == want
    np.testing.assert_array_equal(gpu.peaks.bin_index.cpu().numpy(), cpu.peaks.bin_index.numpy())
    np.testing.assert_allclose(
        gpu.correlation.lag_samples.cpu().numpy(), cpu.correlation.lag_samples.numpy(), atol=1e-3
    )
    pos = gpu.fix.position_enu.cpu().numpy()
    np.testing.assert_allclose(pos, cpu.fix.position_enu.numpy(), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 50.0


def elt_scene(dwells, n, seed=11):
    """The 121.5 MHz ELT case of ``tests/test_validation_scenarios.py``: a
    5 kHz chirp at +12 kHz from (35.46, −97.50) to the OKC buoys, 2.048
    MS/s, SNR 22 dB, ``dwells × n`` samples. Returns ``(cap, config)``
    with max_lag 600, power offset 40 dB and 4 solver starts."""
    scen = sim.Scenario(
        buoys=tuple(sim.Buoy(b, la, ln, al) for b, la, ln, al in sim.OKC_BUOYS),
        emitters=(sim.Emitter(lat=35.46, lng=-97.50, signal="chirp", bandwidth_hz=5e3,
                              freq_offset_hz=12_000.0),),
        center_frequency_mhz=121.5, sample_rate_hz=2_048_000.0, block_len=dwells * n,
        snr_db=22.0, seed=seed,
    )
    cfg = PipelineConfig(num_buoys=4, block_len=n, sample_rate_hz=scen.sample_rate_hz, max_lag=600,
                         power_offset_db=40.0, solver_starts=4, correlation_dwells=dwells)
    return sim.synthesize(scen), cfg


@pytest.mark.cuda
def test_multidwell_on_card_matches_cpu(cuda_device):
    """The ELT scene at 4 dwells × 16384 (K7 on the card for the dwell
    PSD) vs the CPU: detections equal, lags within 1e-2 samples (a 5 kHz
    chirp's correlation peak is hundreds of samples wide, so the
    parabolic refine moves with float32 sums), fixes within 1 m."""
    cap, cfg = elt_scene(4, 16384)
    host = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
            for a in (cap.iq.real, cap.iq.imag, cap.buoy_enu)]
    cpu = TDOAPipeline(cfg, device="cpu").step_split(*host)
    before = fft_natural.launch_count
    gpu = TDOAPipeline(cfg, device=cuda_device).step_split(*(a.to(cuda_device) for a in host))
    torch.cuda.synchronize()
    assert fft_natural.launch_count == before + 1
    np.testing.assert_array_equal(gpu.peaks.bin_index.cpu().numpy(), cpu.peaks.bin_index.numpy())
    np.testing.assert_array_equal(gpu.peaks.valid.cpu().numpy(), cpu.peaks.valid.numpy())
    np.testing.assert_allclose(
        gpu.correlation.lag_samples.cpu().numpy(), cpu.correlation.lag_samples.numpy(), atol=1e-2
    )
    np.testing.assert_allclose(gpu.fix.position_enu.cpu().numpy(), cpu.fix.position_enu.numpy(), atol=1.0)


@pytest.mark.cuda
def test_buoy_dwell_on_card_matches_cpu(cuda_device):
    """One 16384-sample dwell per buoy: peaks and bandwidths equal, power
    within 1e-3 dB."""
    from radio_mapper_tpu_torch.runtime import buoy_detect

    cap = sim.synthesize(sim.default_scenario(signal="fm", bandwidth_hz=16e3, freq_offset_hz=150e3,
                                              snr_db=25.0, seed=5, block_len=16384))
    host = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) for a in (cap.iq.real, cap.iq.imag)]
    kw = dict(sample_rate_hz=cap.scenario.sample_rate_hz, max_peaks=8, threshold_db=-70.0,
              power_offset_db=40.0)
    cpu_peaks, cpu_bw = buoy_detect.detect_dwell(*host, **kw)
    before = fft_natural.launch_count
    peaks, bw = buoy_detect.detect_dwell(*(a.to(cuda_device) for a in host), **kw)
    torch.cuda.synchronize()
    assert fft_natural.launch_count == before + 1
    np.testing.assert_array_equal(peaks.bin_index.cpu().numpy(), cpu_peaks.bin_index.numpy())
    np.testing.assert_array_equal(peaks.valid.cpu().numpy(), cpu_peaks.valid.numpy())
    np.testing.assert_allclose(peaks.power_db.cpu().numpy(), cpu_peaks.power_db.numpy(), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(bw.cpu().numpy(), cpu_bw.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(6, 16384), (3, 32768)])
def test_complex_fft_ifft_through_k7_match_plain(cuda_device, rows, n):
    """The complex ``fft`` and ``ifft`` at lengths routed to K7 split the
    complex64 rows into contiguous planes, launch K7 once each and agree
    with the plain four-step on the same card tensors."""
    from radio_mapper_tpu_torch.ops import fft as fft_ops

    re, im = tone_rows(rows, n, 17)
    x = torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(cuda_device)
    assert fft_ops.route(n, x.device) == "k7"
    before = fft_natural.launch_count
    y = fft_ops.fft(x)
    back = fft_ops.ifft(y)
    torch.cuda.synchronize()
    assert fft_natural.launch_count == before + 2
    assert y.dtype == torch.complex64 and y.shape == x.shape
    ref = fft_ops.fft_re_im_plain(x.real.contiguous(), x.imag.contiguous())
    assert_spectra_close([y.real.cpu(), y.imag.cpu()], [r.cpu() for r in ref])
    assert_spectra_close([back.real.cpu(), back.imag.cpu()], [x.real.cpu(), x.imag.cpu()])


@pytest.mark.cuda
def test_complex_step_on_card_matches_cpu(cuda_device):
    """The library-surface scene (4 buoys, 16384 samples, max_lag 600)
    through the complex ``step``: K7 runs the detection spectrum; lags
    within 1e-3 samples, the fix within 0.5 m of the CPU's and 50 m of the
    emitter."""
    cap = sim.synthesize(sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8))
    cfg = PipelineConfig(num_buoys=4, block_len=cap.scenario.block_len, sample_rate_hz=cap.scenario.sample_rate_hz,
                         max_lag=600, power_offset_db=40.0)
    host = [torch.from_numpy(cap.iq.astype(np.complex64)), torch.from_numpy(cap.buoy_enu.astype(np.float32))]
    cpu = TDOAPipeline(cfg, device="cpu").step(*host)
    before = fft_natural.launch_count
    gpu = TDOAPipeline(cfg, device=cuda_device).step(*(a.to(cuda_device) for a in host))
    torch.cuda.synchronize()
    assert fft_natural.launch_count == before + 1
    np.testing.assert_array_equal(gpu.peaks.bin_index.cpu().numpy(), cpu.peaks.bin_index.numpy())
    np.testing.assert_allclose(
        gpu.correlation.lag_samples.cpu().numpy(), cpu.correlation.lag_samples.numpy(), atol=1e-3
    )
    pos = gpu.fix.position_enu.cpu().numpy()
    np.testing.assert_allclose(pos, cpu.fix.position_enu.numpy(), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 50.0


@pytest.mark.cuda
def test_complex_streaming_on_card_matches_cpu(cuda_device):
    """``tests/test_streaming_tdoa.py``'s scene through ``StreamingTDOA.scan``
    (4 buoys, 8 subchannels × 6 taps, two 16384-sample blocks): the
    emitter's subchannel within 1e-3 subchannel samples and 0.5 m of the
    CPU's, and within 600 m of the emitter."""
    from radio_mapper_tpu_torch.models.streaming_tdoa import StreamingTDOA, StreamingTDOAConfig

    scen = sim.default_scenario(signal="noise", bandwidth_hz=110e3, snr_db=25.0, seed=6, block_len=32_768)
    cap = sim.synthesize(scen)
    cfg = StreamingTDOAConfig(num_buoys=4, num_subchannels=8, taps_per_channel=6, sample_rate_hz=scen.sample_rate_hz,
                              block_len=16_384, max_lag=8, solver_iterations=25)
    host = [torch.from_numpy(cap.iq.astype(np.complex64).reshape(4, 2, 16_384).transpose(1, 0, 2).copy()),
            torch.from_numpy(cap.buoy_enu.astype(np.float32))]
    _, cpu = StreamingTDOA(cfg, device="cpu").scan(*host)
    _, gpu = StreamingTDOA(cfg, device=cuda_device).scan(*(a.to(cuda_device) for a in host))
    best = int(np.argmax(cpu.weights[1].numpy().sum(-1)))
    assert best == int(np.argmax(gpu.weights[1].cpu().numpy().sum(-1)))
    np.testing.assert_allclose(gpu.lags[:, best].cpu().numpy(), cpu.lags[:, best].numpy(), atol=1e-3)
    pos = gpu.fixes_enu[1, best].cpu().numpy()
    np.testing.assert_allclose(pos, cpu.fixes_enu[1, best].numpy(), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 600.0


# -- the multi-device layer (``-k parallel``): ranks on the card vs ranks on the CPU


def _parallel_cases():
    """The card checks' inputs: the 8-buoy EP scene of ``tests/test_pair_ep.py``
    (K3, K5); config 5's shape cut to 4 channels × 16384 samples on scenes
    of 8 buoys (K3, K2); the small wideband config-4 scene (K3, K5)."""
    from radio_mapper_tpu_torch.parallel.pair_ep import PairEPConfig
    from radio_mapper_tpu_torch.parallel.sharded import ShardedStepConfig

    grid = [(f"b{k}", 35.40 + 0.05 * (k % 4), -97.60 + 0.06 * (k // 4), 0.0) for k in range(8)]
    cap = sim.synthesize(sim.default_scenario(block_len=4096, snr_db=25.0, seed=11, bandwidth_hz=500e3, buoys=grid))
    ep = dict(config=PairEPConfig(num_buoys=8, block_len=4096, sample_rate_hz=cap.scenario.sample_rate_hz,
                                  max_lag=256),
              re=cap.iq.real.astype(np.float32), im=cap.iq.imag.astype(np.float32),
              anchors=cap.buoy_enu.astype(np.float32))
    c5 = ShardedStepConfig(num_channels=4, num_buoys=8, num_subchannels=16, taps_per_channel=4,
                           sample_rate_hz=2_400_000.0, max_lag=32)
    caps = [sim.synthesize(sim.default_scenario(
        block_len=16_384, snr_db=25.0, seed=20 + c, bandwidth_hz=300e3, sample_rate_hz=2_400_000.0, buoys=grid,
        emitter_lat=35.45 + 0.01 * c, emitter_lng=-97.55,
    )) for c in range(c5.num_channels)]
    x = np.stack([c.iq for c in caps])
    sharded = dict(config=c5, x=(x.real.astype(np.float32), x.imag.astype(np.float32)),
                   anchors=caps[0].buoy_enu.astype(np.float32), split=True)
    wcfg = small_wideband_config()
    re, im, anchors, _ = wideband_scene(wcfg, 3, 2)
    return ep, sharded, dict(config=wcfg, re=re, im=im, anchors=anchors)


@pytest.fixture(scope="module")
def parallel_runs():
    """Each world size's outputs on the card (its default routes) and on
    CPU ranks (the fused chain forced on: the same algorithm on the plain
    versions): ``{(where, world): [ep, sharded, wideband] of rank 0}``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    from radio_mapper_tpu_torch.parallel import jobs, launch

    ep, sharded, wide = _parallel_cases()
    out = {}
    for where in ("cuda", "cpu"):
        fused = "auto" if where == "cuda" else "on"
        for world in (1, 2):
            todo = [(jobs.ep_step, dict(ep, fused=fused)),
                    (jobs.sharded_step, dict(sharded, mesh_shape=(1, world), fused=fused)),
                    (jobs.wideband_sharded, wide)]
            ranks = launch.run_ranks(jobs.run_jobs, world, device=where, args=(todo,), timeout_s=600)
            for r in ranks[1:]:  # the EP fix is the same on every rank
                np.testing.assert_array_equal(r[0].fix_enu, ranks[0][0].fix_enu)
            out[where, world] = ranks[0]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_parallel_ep_on_card_matches_cpu(parallel_runs, world):
    """EP at world size 1 (NCCL) and 2 (two ranks on one card, gloo):
    lags within 1e-3 samples and the fix within 0.5 m of the CPU ranks'."""
    gpu, cpu = parallel_runs["cuda", world][0], parallel_runs["cpu", world][0]
    np.testing.assert_allclose(gpu.lags, cpu.lags, atol=1e-3)
    np.testing.assert_allclose(gpu.fix_enu, cpu.fix_enu, atol=0.5)
    np.testing.assert_allclose(gpu.fix_enu, parallel_runs["cuda", 1][0].fix_enu, atol=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_parallel_sharded_step_on_card_matches_cpu(parallel_runs, world):
    """The sharded split step on a (1, world) mesh (K3 → K2 on the card):
    on the subchannels whose peaks stand clear (the CPU's mean pair weight
    above 0.5) lags within 1e-3 samples and fixes within 0.5 m."""
    gpu, cpu = parallel_runs["cuda", world][1], parallel_runs["cpu", world][1]
    strong = cpu.weights.mean(axis=-1) > 0.5
    assert strong.any() and all(np.isfinite(v).all() for v in gpu)
    np.testing.assert_allclose(gpu.lags[strong], cpu.lags[strong], atol=1e-3)
    np.testing.assert_allclose(gpu.fixes_enu[strong], cpu.fixes_enu[strong], atol=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_parallel_wideband_on_card_matches_cpu(parallel_runs, world):
    """The sharded wideband step (K3 → K5 on the card) on the emitter's
    subchannel: lags within 1e-3 samples and the fix within 0.5 m."""
    gpu, cpu = parallel_runs["cuda", world][2], parallel_runs["cpu", world][2]
    np.testing.assert_allclose(gpu.lags[3], cpu.lags[3], atol=1e-3)
    np.testing.assert_allclose(gpu.fixes_enu[3], cpu.fixes_enu[3], atol=0.5)


@pytest.mark.cuda
def test_parallel_dryrun_multichip_on_card(cuda_device):
    """``dryrun_multichip(2)`` on the card: two ranks on the cards there
    are, every leg."""
    from radio_mapper_tpu_torch import entry

    s = entry.dryrun_multichip(2)
    assert s[0]["config5"] == (2, 256, 16, 3) and s[0]["flagship"] == (32, 3)
    np.testing.assert_array_equal(s[0]["ep64"], s[1]["ep64"])


@pytest.mark.cuda
def test_parallel_nccl_shift_across_cards():
    """With two or more cards (one rank a card, NCCL): the halo shift's
    ``batch_isend_irecv`` path, left and right, with and without wrap,
    equal bit for bit to CPU ranks' (gloo: an all_gather of the tails);
    and the sharded split step on a (1, cards) mesh against CPU ranks, as
    ``test_parallel_sharded_step_on_card_matches_cpu``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards: NCCL takes one rank a card, so one card has no NCCL shift")
    from radio_mapper_tpu_torch.parallel import jobs, launch

    assert launch.default_backend("cuda", n) == "nccl"
    _, sharded, _ = _parallel_cases()
    x = np.arange(2 * 8 * n, dtype=np.float32).reshape(2, 8 * n)
    out = {}
    for where, fused in (("cuda", "auto"), ("cpu", "on")):
        todo = [(jobs.halos, dict(x=x, halo_len=3, mesh_shape=(1, n))),
                (jobs.sharded_step, dict(sharded, mesh_shape=(1, n), fused=fused))]
        out[where] = launch.run_ranks(jobs.run_jobs, n, device=where, args=(todo,), timeout_s=600)
    for rank in range(n):
        for key, v in out["cpu"][rank][0].items():
            np.testing.assert_array_equal(out["cuda"][rank][0][key], v, err_msg=f"rank {rank} {key}")
    gpu, cpu = out["cuda"][0][1], out["cpu"][0][1]
    strong = cpu.weights.mean(axis=-1) > 0.5
    assert strong.any()
    np.testing.assert_allclose(gpu.lags[strong], cpu.lags[strong], atol=1e-3)
    np.testing.assert_allclose(gpu.fixes_enu[strong], cpu.fixes_enu[strong], atol=0.5)


@pytest.mark.cuda
def test_node_ingest_loop_on_card_equals_the_direct_step(cuda_device):
    """``IngestLoop`` over an unpaced synthetic ring (every byte read is the
    seed's stream) through pinned slots and a side stream: each output
    equal, bit for bit, to ``step_split_uint8`` on the same bytes, K1 and
    K2 once a step (``-k node``)."""
    from radio_mapper_tpu_torch.ingest import native, runner

    ch, b, n, steps = 4, 8, 16_384, 4
    pipe = TDOAPipeline(PipelineConfig(num_buoys=b, block_len=n, sample_rate_hz=2.4e6, max_lag=512),
                        device=cuda_device)
    anchors = torch.from_numpy(np.random.default_rng(0).normal(scale=8e3, size=(ch, b, 3)).astype(np.float32))
    loop = runner.IngestLoop.from_pipeline(pipe, None, channels=ch, anchors=anchors.to(cuda_device))
    outs, step = [], loop.step
    loop.step = lambda raw, a: outs.append(step(raw, a)) or outs[-1]
    loop.warm_compile()
    outs.clear()
    ring = 1 << 23
    loop.ingest = native.NativeIngest.open_synthetic(3, ring_bytes=ring)
    k1, k2 = fft_detect.launch_count, gcc_pair.launch_count
    try:
        stats = loop.run(steps, warmup_steps=0)
    finally:
        loop.ingest.close()
    assert (fft_detect.launch_count - k1, gcc_pair.launch_count - k2) == (steps, steps)
    assert stats.bytes_consumed == steps * loop.block_bytes and loop.copy_ms_per_step() > 0
    again = native.NativeIngest.open_synthetic(3, ring_bytes=ring)
    try:
        for out in outs:
            raw, _ = again.read_bytes(loop.block_bytes, 30_000)
            direct = pipe.step_split_uint8(torch.from_numpy(raw.reshape(ch, b, 2 * n)).to(cuda_device),
                                           anchors.to(cuda_device))
            leaves = lambda x: [x] if isinstance(x, torch.Tensor) else [t for f in x for t in leaves(f)]
            for x, y in zip(leaves(out), leaves(direct)):
                assert torch.equal(x, y)
    finally:
        again.close()


@pytest.mark.cuda
def test_node_buoy_on_card_matches_cpu(cuda_device):
    """``BuoyNode.detect_block`` on the card (K7 once a dwell) and on the CPU
    on the same simulated dwell: the same detections and bandwidths
    (``-k node``)."""
    from radio_mapper_tpu_torch.runtime import buoy

    scen = sim.default_scenario(signal="fm", bandwidth_hz=16e3, freq_offset_hz=150e3, snr_db=25.0, seed=5)
    node = buoy.simulated_buoy(scen, 0, device=cuda_device)
    cpu = buoy.BuoyNode(node.config, source=node.source, gps=node.gps, device="cpu")
    iq = node.source.read(node.config.block_len)
    before = fft_natural.launch_count
    gpu_dets = node.detect_block(iq, 121.5e6)
    assert fft_natural.launch_count == before + 1
    cpu_dets = cpu.detect_block(iq, 121.5e6)
    assert [(d.frequency_mhz, d.confidence) for d in gpu_dets] == [(d.frequency_mhz, d.confidence) for d in cpu_dets]
    assert gpu_dets and np.array_equal(node.last_bandwidths_hz, cpu.last_bandwidths_hz)


@pytest.mark.cuda
def test_node_buoy_over_rtl_tcp_on_card_matches_cpu(cuda_device):
    """A buoy on the card fed by rtl_tcp: an in-process ``RtlTcpServer`` on
    port 0 (unthrottled) serving the FM scene, ``RtlTcpSource`` under a
    card ``BuoyNode.scan_once()`` (K7 once a dwell), and a CPU node's
    ``detect_block`` on the samples the card node read: the same
    detections, at least one (``-k node``)."""
    import asyncio

    from radio_mapper_tpu_torch import constants
    from radio_mapper_tpu_torch.ingest import SimulatedSource
    from radio_mapper_tpu_torch.net import rtl_tcp
    from radio_mapper_tpu_torch.runtime import buoy

    scen = sim.default_scenario(signal="fm", bandwidth_hz=16e3, freq_offset_hz=150e3, snr_db=25.0, seed=5)
    server = rtl_tcp.RtlTcpServer(SimulatedSource(scen, 0), host="127.0.0.1", port=0, throttle=False)
    rtl_tcp.serve_in_thread(server)
    src = rtl_tcp.RtlTcpSource("127.0.0.1", server.port, sample_rate_hz=scen.sample_rate_hz)
    try:
        cfg = buoy.BuoyNodeConfig(buoy_id="tcp", lat=35.5, lng=-97.5, sample_rate_hz=src.sample_rate_hz)
        node = buoy.BuoyNode(cfg, source=src, device=cuda_device)
        node.gps.initialize()
        node.schedule = (constants.ScheduleEntry(121.5, 35.0, "emergency"),)
        seen, read = [], src.read
        src.read = lambda n: seen.append(read(n)) or seen[-1]
        before = fft_natural.launch_count
        gpu_dets = asyncio.run(node.scan_once())
        assert fft_natural.launch_count == before + 1
    finally:
        src.close()
    cpu = buoy.BuoyNode(cfg, source=None, gps=node.gps, device="cpu")
    cpu_dets = cpu.detect_block(seen[-1], 121.5e6)
    assert [(d.frequency_mhz, d.confidence, d.signal_type) for d in gpu_dets] == [
        (d.frequency_mhz, d.confidence, d.signal_type) for d in cpu_dets]
    assert gpu_dets and np.array_equal(node.last_bandwidths_hz, cpu.last_bandwidths_hz)


# -- the LM solve as one launch (``-k lm_kernel``) ---------------------------

# name → (problems' lead shape, receivers, iterations, solve_2d, edit)
LM_CASES = {
    "flagship": ((128, 128), 8, 40, True, None),
    "3d": ((1024,), 8, 40, False, None),
    "weights_none": ((1024,), 8, 40, True, "weights_none"),
    "zero_weight_row": ((1024,), 8, 40, True, "zero_row"),
    "nan_dd": ((1024,), 8, 40, True, "nan"),
    "collinear": ((1024,), 8, 40, True, "collinear"),
    "three_receivers": ((1024,), 3, 40, True, None),
    "64_receivers": ((64,), 64, 15, True, None),
}


def _lm_inputs(dev, lead, b, edit, seed=11, init=None):
    """:func:`solver.lm_setup`'s output on the card for seeded problems
    with ``edit`` applied (:func:`testing.lm_problems`; "weights_none":
    no weights)."""
    anchors, pi, pj, dd, w = testing.lm_problems(lead, b, seed, edit=None if edit == "weights_none" else edit)
    weights = None if edit == "weights_none" else w.to(dev)
    on = lambda t: None if t is None else t.to(dev)
    return solver.lm_setup(*(on(t) for t in (anchors, pi, pj, dd)), weights, init_enu=on(init))


def _lm_compare(args, loop, kern, iterations, solve_2d):
    """The kernel's (x, cost) against the loop's on the card, on the same
    set-up ``args``. Basis: the loop itself, run on the CPU on the same
    set-up, differs from the loop on the card by float32 sums taken in
    another order (cuBLAS's and torch's reduction trees against the CPU's),
    which the accept test ``cost_new < cost`` carries into the steps taken:
    up to 3.5 cm at the flagship's shape, 1.6 m along collinear receivers'
    flat valley (measured on an H100). The kernel takes the loop's
    operations with its sums in index order, so it may lie no further
    from the card's loop than twice that spread: max |Δx| ≤ 2·max
    |x_cpu − x_card| + 1 mm and max |Δcost| ≤ 2·max |cost_cpu − cost_card|
    + 1e-6·max cost; NaN exactly where the loop has it."""
    (xl, cl), (xk, ck) = loop, kern
    xc, cc = (t.to(xl.device) for t in solver.lm_loop(*(a.cpu() for a in args), iterations=iterations,
                                                      solve_2d=solve_2d))
    assert xk.shape == xl.shape and ck.shape == cl.shape
    assert torch.equal(torch.isnan(xk), torch.isnan(xl)) and torch.equal(torch.isnan(ck), torch.isnan(cl))
    gap = lambda a, b: (a - b).abs().nan_to_num(0.0).max().item()
    assert gap(xk, xl) <= 2 * gap(xc, xl) + 1e-3
    assert gap(ck, cl) <= 2 * gap(cc, cl) + 1e-6 * cl.abs().nan_to_num(0.0).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_kernel_matches_loop(cuda_device, case):
    """``lm_solve.lm_solve`` (one launch) against ``solver.lm_loop`` on the
    card, on the same set-up: the flagship's 16,384 problems (thread
    layout), 3-D, no weights, all-zero and partly zero weight rows, NaN
    measurements, collinear receivers, three receivers, and 64 receivers
    (P = 2016, the warp layout)."""
    lead, b, iterations, solve_2d, edit = LM_CASES[case]
    args = _lm_inputs(cuda_device, lead, b, edit)
    loop = solver.lm_loop(*args, iterations=iterations, solve_2d=solve_2d)
    before = dict(lm_solve.layout_counts)
    kern = lm_solve.lm_solve(*args, iterations=iterations, solve_2d=solve_2d)
    torch.cuda.synchronize()
    kind = "warp" if b == 64 else "thread"
    assert lm_solve.layout_counts[kind] == before[kind] + 1
    _lm_compare(args, loop, kern, iterations, solve_2d)
    if edit == "nan":
        assert torch.isnan(kern[0][3]).all() and torch.isnan(kern[1][3:5]).all()
        assert torch.equal(kern[0][4], args[6][4])  # never improved: still at the start
    else:
        assert torch.isfinite(kern[0]).all() and torch.isfinite(kern[1]).all()


def _lm_lanes(p, b):
    """The kernel's pair-sum order at P pairs and B receivers, as
    ``testing.lm_emulate`` takes it."""
    return 32 if lm_solve.layout(p, b) == "warp" else 0


def _assert_bits_equal(got, want):
    """The same NaNs, and every other float32 bit for bit."""
    got = got.cpu().numpy().reshape(want.shape)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


# name → (problems, receivers, iterations, solve_2d, edit)
LM_EMULATED = {
    "2d": ((64,), 8, 40, True, None),
    "3d_heights": ((64,), 8, 40, False, "heights"),
    "weights_none": ((64,), 8, 40, True, "weights_none"),
    "zero_weight_row": ((64,), 8, 40, True, "zero_row"),
    "nan_dd": ((64,), 8, 40, True, "nan"),
    "collinear": ((64,), 8, 40, True, "collinear"),
    "three_receivers": ((64,), 3, 40, True, None),
    "few_iterations": ((64,), 8, 2, True, None),
    "64_receivers": ((8,), 64, 15, True, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LM_EMULATED))
def test_lm_kernel_equals_its_float32_emulation(cuda_device, case):
    """The kernel against ``testing.lm_emulate`` (the loop's formulas with
    each operation rounded to float32 on its own and the pair sums in the
    kernel's order) at small shapes: bit for bit, positions and costs,
    NaN where the emulation has it. A wrong step, damping, lam schedule,
    accept test, iteration count or sum order changes bits."""
    lead, b, iterations, solve_2d, edit = LM_EMULATED[case]
    args = _lm_inputs(cuda_device, lead, b, edit)
    x, cost = lm_solve.lm_solve(*args, iterations=iterations, solve_2d=solve_2d)
    _, flat = lm_solve.flatten_problems(args[0], *args[3:])
    fa, fd, fw, fs, fx = (t.cpu().numpy() for t in flat)
    pi, pj = (t.cpu().numpy() for t in args[1:3])
    xe, ce = testing.lm_emulate(fa, pi, pj, fd, fw, fs, fx, iterations=iterations, solve_2d=solve_2d,
                                lanes=_lm_lanes(fd.shape[-1], b))
    _assert_bits_equal(x, xe)
    _assert_bits_equal(cost, ce)


@pytest.mark.cuda
def test_lm_kernel_matches_loop_at_narrowbands_multistart(cuda_device):
    """Narrowband's solve: 4 starts × 2 captures × 128 channels in one
    launch, from :func:`solver.perturbed_starts`, kernel against loop."""
    anchors, *_ = testing.lm_problems((), 8, 11)
    starts = solver.perturbed_starts(anchors, 4)[:, None, None, :]  # [4, 1, 1, 3]
    args = _lm_inputs(cuda_device, (4, 2, 128), 8, None, init=starts)
    loop = solver.lm_loop(*args, iterations=40, solve_2d=True)
    kern = lm_solve.lm_solve(*args, iterations=40, solve_2d=True)
    torch.cuda.synchronize()
    _lm_compare(args, loop, kern, 40, True)


@pytest.mark.cuda
def test_lm_kernel_solve_blocks_nothing_and_records_its_span(cuda_device):
    """A whole ``solve_tdoa`` and ``solve_tdoa_multistart`` at the
    flagship's and narrowband's shapes under
    ``set_sync_debug_mode("error")``: nothing synchronises. A traced solve
    records ``solve.lm.kernel`` once, under ``solve.lm``, with no sync in
    the step. The fixes agree with the CPU's loop within 10 cm: twice the
    loop's own spread between the CPU and the card at this shape (4.5 cm,
    measured on an H100; see :func:`_lm_compare`)."""
    from radio_mapper_tpu_torch.utils import spans

    anchors, pi, pj, dd, w = testing.lm_problems((128, 128), 8, 13)
    on = [t.to(cuda_device) for t in (anchors, pi, pj, dd, w)]
    solver.solve_tdoa(*on)  # builds the library and warms every operator
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = solver.solve_tdoa(*on, iterations=40)
        multi = solver.solve_tdoa_multistart(*(t[:2] if t.dim() > 2 else t for t in on), num_starts=4)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    cpu = solver.solve_tdoa(anchors, pi, pj, dd, w, iterations=40)
    torch.testing.assert_close(res.position_enu.cpu(), cpu.position_enu, rtol=0, atol=0.1)
    assert multi.position_enu.shape == (2, 128, 3)
    with spans._Step(cuda_device):
        solver.solve_tdoa(*on, iterations=40)
    rec = spans.steps()[-1]
    names = [s.name for s in rec.spans]
    assert names == ["step", "solve.prep", "solve.lm", "solve.lm.kernel"]
    assert rec.spans[3].parent == 2 and rec.syncs("step") == 0
    assert rec.device_ms("solve.lm.kernel") > 0


# --- K9, the max pass and K10: the narrowband pair stage (``-k pair_fft``) ---


def _pair_counts():
    return pair_fft.launch_count, pair_fft.max_launch_count, pair_fft.window_launch_count


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,chans,b,length", [(135_000, 16, 8, 131_072), (17_280, 64, 4, 16_384)])
def test_pair_fft_kernels_match_plain_library_and_four_step(cuda_device, nfft, chans, b, length):
    """K9 → max pass → K10 on delayed-noise captures in the decoded
    planes' strided layout, against the plain versions, ``torch.fft`` and
    the matmul four-step (budgets in the module docstring); lags within
    half a sample of the planted delays."""
    from radio_mapper_tpu_torch.ops import split_complex

    lag, eps = 512, 0.05
    re, im, d = testing.delayed_noise(chans, b, length, 200, seed=5, device=cuda_device)
    fre, fim = re.reshape(-1, length), im.reshape(-1, length)
    before = _pair_counts()
    spec = pair_fft.receiver_spectra(fre, fim, nfft)
    mags = pair_fft.lag_mags(spec, b, max_lag=lag, eps=eps)
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_pair_counts(), before)) == (1, 1, 1)

    lib = torch.fft.fft(torch.complex(fre, fim), n=nfft)
    rel = lambda a, ref: ((a - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
    assert rel(torch.complex(*pair_fft.natural(spec)), lib) <= 1e-5
    plain = pair_fft.receiver_spectra_plain(fre, fim, nfft)
    assert rel(spec.flatten(1), plain.flatten(1)) <= 1e-5
    pmax = pair_fft.pair_max(spec, b)
    torch.testing.assert_close(pmax, pair_fft.pair_max_plain(spec, b), rtol=1e-6, atol=0)

    ii, jj = (torch.as_tensor(a, device=cuda_device) for a in np.triu_indices(b, k=1))
    x = lib.reshape(chans, b, nfft)
    r = x[:, ii] * x[:, jj].conj()
    r = torch.fft.ifft(r / (r.abs() + eps * r.abs().amax(-1, keepdim=True) + 1e-30))
    fr, fi, _ = split_complex.receiver_spectra_split(re, im, max_lag=lag)
    refs = {
        "plain": pair_fft.lag_mags_plain(spec, pmax, b, max_lag=lag, eps=eps),
        "torch.fft": torch.cat([r[..., nfft - lag:], r[..., : lag + 1]], -1).abs(),
        "four-step": gcc_phat.pair_lag_mags(fr, fi, ii, jj, max_lag=lag, eps=eps),
    }
    peaks = lambda m: gcc_phat.peaks_from_lag_mags(m, sample_rate_hz=1.0, max_lag=lag)
    ours = peaks(mags)
    for name, ref in refs.items():
        pr = peaks(ref)
        assert ((mags - ref).abs().amax(-1) / ref.amax(-1)).max().item() <= 1e-4, name
        assert torch.equal(mags.argmax(-1), ref.argmax(-1)), name
        assert (ours.lag_samples - pr.lag_samples).abs().max().item() <= 4.6e-5, name
        assert ((ours.psr - pr.psr).abs() / pr.psr).max().item() <= 1e-3, name
    truth = (d[:, jj] - d[:, ii]).to(torch.float32)
    assert (ours.lag_samples - truth).abs().max().item() < 0.5


@pytest.mark.cuda
def test_narrowband_uint8_step_runs_the_pair_kernels_once(cuda_device):
    """The ELT scene at 8 dwells × 16384, max_lag 512 (nfft 135000), as
    uint8 bytes through ``step_split_uint8``: K7, K9, the max pass, K10
    and the LM once each for the call's one chunk of the pair stage; on
    the card as on the CPU (the four-step): detections equal, lags within
    1e-2 samples, fixes within 1 m (``test_multidwell_on_card_matches_cpu``'s
    budgets for this scene)."""
    import dataclasses

    from radio_mapper_tpu_torch.ops import fft as fft_ops

    cap, cfg = elt_scene(8, 16384)
    cfg = dataclasses.replace(cfg, max_lag=512)
    assert fft_ops.friendly_fft_len(8 * 16384 + 512) == 135_000
    scaled = cap.iq * (32.0 / np.sqrt(np.mean(np.abs(cap.iq) ** 2)))
    raw = np.empty((cap.iq.shape[0], 2 * cap.iq.shape[1]), dtype=np.uint8)
    raw[:, 0::2] = np.clip(np.round(scaled.real + 127.5), 0, 255)
    raw[:, 1::2] = np.clip(np.round(scaled.imag + 127.5), 0, 255)
    host = torch.from_numpy(raw), torch.from_numpy(cap.buoy_enu.astype(np.float32))
    cpu = TDOAPipeline(cfg, device="cpu").step_split_uint8(*host)
    before = _pair_counts(), fft_natural.launch_count, lm_solve.launch_count
    gpu = TDOAPipeline(cfg, device=cuda_device).step_split_uint8(*(a.to(cuda_device) for a in host))
    torch.cuda.synchronize()
    after = _pair_counts(), fft_natural.launch_count, lm_solve.launch_count
    assert tuple(a - c for a, c in zip(after[0], before[0])) == (1, 1, 1)
    assert (after[1] - before[1], after[2] - before[2]) == (1, 1)
    np.testing.assert_array_equal(gpu.peaks.bin_index.cpu().numpy(), cpu.peaks.bin_index.numpy())
    np.testing.assert_array_equal(gpu.peaks.valid.cpu().numpy(), cpu.peaks.valid.numpy())
    np.testing.assert_allclose(
        gpu.correlation.lag_samples.cpu().numpy(), cpu.correlation.lag_samples.numpy(), atol=1e-2
    )
    np.testing.assert_allclose(gpu.fix.position_enu.cpu().numpy(), cpu.fix.position_enu.numpy(), atol=1.0)


@pytest.mark.cuda
def test_complex_step_at_17280_runs_the_pair_kernels(cuda_device):
    """The complex ``step`` on the noise scene at block_len 16384, max_lag
    512 (pair nfft 17280 = 1080·16): K9, the max pass and K10 once each;
    lags within 1e-3 samples and the fix within 0.5 m of the CPU's four-step
    (the pipeline tests' card-vs-CPU budgets), within 50 m of the emitter."""
    cap = sim.synthesize(sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8))
    cfg = PipelineConfig(num_buoys=4, block_len=16384, sample_rate_hz=cap.scenario.sample_rate_hz, max_lag=512,
                         power_offset_db=40.0)
    host = torch.from_numpy(cap.iq.astype(np.complex64)), torch.from_numpy(cap.buoy_enu.astype(np.float32))
    cpu = TDOAPipeline(cfg, device="cpu").step(*host)
    before = _pair_counts()
    gpu = TDOAPipeline(cfg, device=cuda_device).step(*(a.to(cuda_device) for a in host))
    torch.cuda.synchronize()
    assert tuple(a - c for a, c in zip(_pair_counts(), before)) == (1, 1, 1)
    np.testing.assert_allclose(
        gpu.correlation.lag_samples.cpu().numpy(), cpu.correlation.lag_samples.numpy(), atol=1e-3
    )
    pos = gpu.fix.position_enu.cpu().numpy()
    np.testing.assert_allclose(pos, cpu.fix.position_enu.numpy(), atol=0.5)
    assert np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]) < 50.0

