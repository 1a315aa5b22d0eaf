"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch with CUDA:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test here skips (a CUDA kernel has no CPU mode).
The input builders and comparisons are shared with the JAX parity tests
(``test_torch_fft_detect.py``, ``test_torch_gcc_pair.py``), so the kernel
is held to the same tolerances as the plain version is against JAX:

- K1 spectra within 1e-4 of the row's max |X|, ``row_max`` within 1e-5
  relative, ``noise_floor_db`` within 1e-3 dB (log10 differs by ulps
  between libraries), segment partials exact outside float32-tied
  segments (see :func:`fragile_segments`), scores within 1e-4 of the
  row's max power;
- K2 lag windows within 1e-4 of each pair's window max.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline
from radio_mapper_tpu_torch.ops import ct_plan, gcc_phat
from radio_mapper_tpu_torch.ops.cuda import fft_detect, gcc_pair

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


def assert_k1_close(out, ref, plan):
    """K1 outputs ``out`` against reference outputs ``ref`` (numpy-able)."""
    fr, fi, score, arg, nf, rmax = (np.asarray(o) for o in ref)
    ofr, ofi, oscore, oarg, onf, ormax = (np.asarray(o) for o in out)
    mag = np.sqrt(fr.astype(np.float64) ** 2 + fi.astype(np.float64) ** 2).max(axis=-1, keepdims=True)
    assert (np.abs(ofr - fr).max(axis=-1, keepdims=True) <= 1e-4 * mag).all()
    assert (np.abs(ofi - fi).max(axis=-1, keepdims=True) <= 1e-4 * mag).all()
    np.testing.assert_allclose(ormax, rmax, rtol=1e-5)
    np.testing.assert_allclose(onf, nf, atol=1e-3, rtol=0)

    fragile = fragile_segments(fr, fi, nf, plan)
    assert fragile.mean() < 0.01, fragile.mean()
    solid = ~fragile
    np.testing.assert_array_equal(np.isfinite(oscore)[solid], np.isfinite(score)[solid])
    both = solid & np.isfinite(score) & np.isfinite(oscore)
    assert both.sum() > 0
    np.testing.assert_array_equal(oarg[both], arg[both])
    pmax = np.broadcast_to(rmax[:, None], score.shape)
    assert (np.abs(oscore[both] - score[both]) <= 1e-4 * pmax[both]).all()


def assert_windows_close(ours, ref):
    """Lag windows within 1e-4 of each pair's window max."""
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-4 * scale).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full FP32
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("nfft,n_valid", [(9216, 8192), (17408, 16384)])
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
@pytest.mark.parametrize("c,b,nfft,max_lag", [(2, 4, 9216, 256), (4, 8, 17408, 512)])
def test_k2_kernel_matches_plain(cuda_device, c, b, nfft, max_lag):
    sre, sim_, smax = (torch.from_numpy(a).to(cuda_device) for a in correlated_spectra(c, b, nfft, 5))
    pi, pj = gcc_phat.pair_indices(b)
    before = gcc_pair.launch_count
    out = gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, max_lag=max_lag)
    torch.cuda.synchronize()
    assert gcc_pair.launch_count == before + 1
    ref = gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, smax, pi, pj, max_lag=max_lag)
    assert_windows_close(out.cpu().numpy(), ref.cpu().numpy())


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
