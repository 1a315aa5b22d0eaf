"""Kernels K9 and K10 (``csrc/pair_fft.cu`` on ``csrc/mixed_fft.cuh``):
their radix schedules replayed in numpy, their plans and tables against
the source, the route, and the plain versions against the four-step.

No JAX: the replays are checked against ``np.fft``. The replay runs each
Stockham pass as the kernels do (inputs j + r·N/R, the twiddle
W_{NS·R}^{r·(j mod NS)} read from the float32 table of W_N^e, the
butterflies' formulas, output r to (j / NS)·NS·R + j mod NS + r·NS), in
complex64. Tolerances: float32 rounding of a few ulps a pass, relative to
a row's largest value (max |X| of a spectrum, a window's max |r|): 1e-5
over the 3 to 8 passes of a transform, where a float32 FFT of these
lengths lands at 1e-7 to 1e-6.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch import testing
from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops import gcc_phat, split_complex
from radio_mapper_tpu_torch.ops.cuda import pair_fft
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

CSRC = Path(pair_fft.__file__).resolve().parents[2] / "csrc"
H8 = np.float32(0.707106781186547524)
S3 = np.float32(0.866025403784438647)
C51, C52 = np.float32(0.309016994374947424), np.float32(-0.809016994374947424)
S51, S52 = np.float32(0.951056516295153572), np.float32(0.587785252292473129)


def _c(t):
    """float32 (re, im) pairs → complex64."""
    t = np.asarray(t)
    return (t[..., 0] + 1j * t[..., 1]).astype(np.complex64)


def _rot(a, inverse):
    return a * np.complex64(1j if inverse else -1j)


def _dft4(a0, a1, a2, a3, inverse):
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, _rot(a1 - a3, inverse)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def _dft(v, inverse):
    """``mixed_fft.cuh``'s ``dft<R>`` on a list of R arrays."""
    r = len(v)
    if r == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if r == 3:
        s, d = v[1] + v[2], _rot(v[1] - v[2], inverse) * S3
        m = v[0] - s * np.float32(0.5)
        return [v[0] + s, m + d, m - d]
    if r == 4:
        return _dft4(*v, inverse)
    if r == 5:
        s1, d1, s2, d2 = v[1] + v[4], v[1] - v[4], v[2] + v[3], v[2] - v[3]
        t1 = v[0] + (s1 * C51 + s2 * C52)
        t2 = v[0] + (s1 * C52 + s2 * C51)
        u1 = _rot(d1 * S51 + d2 * S52, inverse)
        u2 = _rot(d1 * S52 - d2 * S51, inverse)
        return [v[0] + (s1 + s2), t1 + u1, t2 + u2, t2 - u2, t1 - u1]
    assert r == 8
    e = _dft4(v[0], v[2], v[4], v[6], inverse)
    o = _dft4(v[1], v[3], v[5], v[7], inverse)
    o[1] = o[1] * np.complex64(H8 * (1 + 1j) if inverse else H8 * (1 - 1j))
    o[2] = _rot(o[2], inverse)
    o[3] = o[3] * np.complex64(H8 * (-1 + 1j) if inverse else H8 * (-1 - 1j))
    return [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]


def stockham_pass(x, radix, ns, roots, inverse):
    """One pass (R, NS) over the last axis of ``x``, as ``mixed_fft.cuh``'s
    ``pass`` and ``butterfly`` run it."""
    n = x.shape[-1]
    m = n // radix
    j = np.arange(m)
    v = [x[..., j + r * m] for r in range(radix)]
    if ns > 1:
        step, k = n // (ns * radix), j % ns
        for r in range(1, radix):
            w = roots[r * k * step]
            v[r] = v[r] * (np.conj(w) if inverse else w)
    v = _dft(v, inverse)
    out = np.empty_like(x)
    for r in range(radix):
        out[..., (j // ns) * ns * radix + j % ns + r * ns] = v[r]
    return out


def stockham(x, radices, roots, inverse=False):
    ns = 1
    for radix in radices:
        x = stockham_pass(x, radix, ns, roots, inverse)
        ns *= radix
    return x


def omega(e, t, inverse=False):
    """W_N^e from the two-level table, as ``mixed_fft.cuh``'s ``omega``."""
    w = _c(t.hi)[e // pair_fft.OMEGA_LO] * _c(t.lo)[e % pair_fft.OMEGA_LO]
    return np.conj(w) if inverse else w


def k9_replay(x, nfft):
    """K9 on complex rows ``x [rows, len]``: the columns kernel (N2-point
    DFTs over t2 of x[t1 + N1·t2], times W_N^(t1·k2), stored k2-major), then
    the rows kernel (N1-point DFTs in place). Returns ``[rows, N2, N1]``."""
    p = pair_fft.PLANS[nfft]
    t = pair_fft.tables(nfft)
    xp = np.zeros((x.shape[0], nfft), np.complex64)
    xp[:, : x.shape[1]] = x
    cols = xp.reshape(-1, p.n2, p.n1).transpose(0, 2, 1)  # [rows, t1, t2]
    a = stockham(cols, p.radix2, _c(t.roots2))  # [rows, t1, k2]
    e = np.arange(p.n1)[:, None] * np.arange(p.n2)[None, :]
    z = (a * omega(e, t)).transpose(0, 2, 1)  # [rows, k2, t1]
    return stockham(np.ascontiguousarray(z), p.radix1, _c(t.roots1))


def k10_replay(spec, b, max_lag, eps):
    """The max pass and K10 on ``spec [chans·B, N2, N1]`` (complex): per
    pair and column, Wh = R / (|R| + eps·max|R| + 1e-30), the N1-point
    inverse, then the window's lags summed over the columns times
    W_N^(−n2·lag). Returns |r| ``[chans, P, 2L+1]``."""
    _, n2, n1 = spec.shape
    nfft = n1 * n2
    p = pair_fft.PLANS[nfft]
    t = pair_fft.tables(nfft)
    i, j = np.triu_indices(b, k=1)
    x = spec.reshape(-1, b, n2, n1)
    r = x[:, i] * np.conj(x[:, j])
    d = np.abs(r)
    wh = (r / (d + np.float32(eps) * d.max(axis=(-2, -1), keepdims=True) + np.float32(1e-30))).astype(np.complex64)
    y = stockham(wh, p.radix1, _c(t.roots1), inverse=True)
    lags = np.arange(-max_lag, max_lag + 1)
    e = np.outer(np.arange(n2), lags) % nfft
    acc = (y[..., lags % n1] * omega(e, t, inverse=True)).sum(axis=-2)
    return np.abs(acc / np.float32(nfft))


def _rows(rows, length, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, length)) + 1j * rng.normal(size=(rows, length))).astype(np.complex64)


def _rel(a, ref):
    """Largest error over the largest magnitude, each row on its own."""
    a, ref = np.asarray(a), np.asarray(ref)
    return float((np.abs(a - ref).reshape(ref.shape[0], -1).max(-1)
                  / np.abs(ref).reshape(ref.shape[0], -1).max(-1)).max())


def _nfft_plan(n):
    """(radices, roots) of one factor length of the plans."""
    for nfft, p in pair_fft.PLANS.items():
        t = pair_fft.tables(nfft)
        if p.n1 == n:
            return p.radix1, _c(t.roots1)
        if p.n2 == n:
            return p.radix2, _c(t.roots2)
    raise KeyError(n)


@pytest.mark.parametrize("n", [1080, 125, 16])
@pytest.mark.parametrize("inverse", [False, True])
def test_stockham_schedule_is_the_dft(n, inverse):
    """Each factor length's plan, replayed pass by pass, against np.fft
    (the inverse without its 1/N, as K10 runs it)."""
    radices, roots = _nfft_plan(n)
    assert int(np.prod(radices)) == n
    x = _rows(4, n, n)
    got = stockham(x, radices, roots, inverse)
    ref = np.fft.ifft(x.astype(np.complex128)) * n if inverse else np.fft.fft(x.astype(np.complex128))
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("radix", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("inverse", [False, True])
def test_butterflies_are_small_dfts(radix, inverse):
    """``dft<R>``'s formulas against the R-point DFT."""
    x = _rows(16, radix, radix + 10 * inverse)
    got = np.stack(_dft([x[:, r] for r in range(radix)], inverse), axis=-1)
    ref = np.fft.ifft(x.astype(np.complex128)) * radix if inverse else np.fft.fft(x.astype(np.complex128))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("nfft,length", [(135_000, 131_072), (17_280, 16_384)])
def test_k9_replay_and_its_output_order(nfft, length):
    """K9's schedule against ``np.fft.fft`` of the zero-padded rows: bin
    N2·k1 + k2 at [k2, k1], the order :func:`pair_fft.natural` undoes."""
    p = pair_fft.PLANS[nfft]
    x = _rows(3, length, nfft)
    spec = k9_replay(x, nfft)
    ref = np.fft.fft(x.astype(np.complex128), n=nfft)
    assert spec.shape == (3, p.n2, p.n1)
    assert _rel(spec.transpose(0, 2, 1).reshape(3, nfft), ref) <= 1e-5
    t = torch.from_numpy(np.stack([spec.real, spec.imag], -1))
    nr, ni = pair_fft.natural(t)
    assert _rel(nr.numpy() + 1j * ni.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("nfft,length,b", [(135_000, 131_072, 3), (17_280, 16_384, 4)])
def test_k10_pruned_window_is_the_full_inverse_window(nfft, length, b):
    """K10's schedule (the N1-point inverse of each column, the window's
    lags summed over columns) on K9's replayed spectra against the full
    float64 inverse of the whitened cross spectrum, cut to the window."""
    lag, eps = 512, 0.05
    re, im, d = testing.delayed_noise(1, b, length, 100, seed=nfft % 97)
    x = (re[0].numpy() + 1j * im[0].numpy()).astype(np.complex64)
    spec = k9_replay(x, nfft)
    got = k10_replay(spec, b, lag, eps)[0]
    xf = np.fft.fft(x.astype(np.complex128), n=nfft)
    i, j = np.triu_indices(b, k=1)
    r = xf[i] * np.conj(xf[j])
    a = np.abs(r)
    full = np.fft.ifft(r / (a + eps * a.max(-1, keepdims=True) + 1e-30))
    ref = np.abs(np.concatenate([full[:, nfft - lag:], full[:, : lag + 1]], -1))
    assert _rel(got, ref) <= 1e-5
    np.testing.assert_array_equal(got.argmax(-1) - lag, (d[0, j] - d[0, i]).numpy())


def test_tables_are_float64_roots_rounded_once():
    """Every table entry is its float64 root rounded to float32; the
    two-level W_N^e is within 2e-7 of the float64 root at every e < N."""
    for nfft, p in pair_fft.PLANS.items():
        t = pair_fft.tables(nfft)
        for table, e, m in ((t.roots1, np.arange(p.n1), p.n1), (t.roots2, np.arange(p.n2), p.n2),
                            (t.lo, np.arange(pair_fft.OMEGA_LO), nfft),
                            (t.hi, np.arange(len(t.hi)) * pair_fft.OMEGA_LO, nfft)):
            w = np.exp(-2j * np.pi * e / m)
            np.testing.assert_array_equal(table, np.stack([w.real, w.imag], -1).astype(np.float32))
        e = np.arange(nfft)
        assert np.abs(omega(e, t) - np.exp(-2j * np.pi * e / nfft)).max() <= 2e-7


def test_plans_match_the_source():
    """``csrc/pair_fft.cu``'s plan structs, its entries' dispatch and its
    max pass's receiver counts, and ``mixed_fft.cuh``'s table split, equal
    :data:`pair_fft.PLANS`, ``MAX_RECEIVERS`` and ``OMEGA_LO``; each plan
    factors its nfft, its N1 holds the narrowband window (2·512 + 1), and
    K10's last pass has NS = N1 / R_last."""
    src = (CSRC / "pair_fft.cu").read_text()
    structs = {}
    for m in re.finditer(r"struct P(\d+) \{.*?N = (\d+), R0 = (\d+), RL = (\d+), NSL = (\d+);(.*?)\n\};", src, re.S):
        mid = re.search(r"smem_passes<N, R0, G, CS, T, INV, ([\d, ]+)>", m.group(6))
        middle = tuple(int(v) for v in mid.group(1).split(",")) if mid else ()
        n, r0, rl, nsl = (int(m.group(k)) for k in range(2, 6))
        structs[n] = ((r0, *middle, rl), nsl)
    for entry in ("rm_pair_fft_spectra", "rm_pair_fft_window"):
        body = src[src.index(f'extern "C" int {entry}'):]
        body = body[: body.index("\n}\n")]
        pairs = {(int(a), int(b)) for a, b in re.findall(r"n1 == (\d+) && n2 == (\d+)", body)}
        assert pairs == {(p.n1, p.n2) for p in pair_fft.PLANS.values()}, entry
    for nfft, p in pair_fft.PLANS.items():
        assert p.n1 * p.n2 == nfft and 2 * 512 + 1 <= p.n1
        for n, radices in ((p.n1, p.radix1), (p.n2, p.radix2)):
            assert structs[n][0] == radices and int(np.prod(radices)) == n
            assert structs[n][1] == n // radices[-1]
    cases = {int(v) for v in re.findall(r"case (\d+): return max_pass<", src)}
    assert cases == set(range(2, pair_fft.MAX_RECEIVERS + 1))
    cuh = (CSRC / "mixed_fft.cuh").read_text()
    assert int(re.search(r"constexpr int OMEGA_LO = (\d+);", cuh).group(1)) == pair_fft.OMEGA_LO


def test_plans_cover_the_pipelines_lengths():
    """The narrowband capture (8 dwells of 16384, max_lag 512) and the
    complex step's block (16384, max_lag 512) plan these lengths."""
    assert fft_ops.friendly_fft_len(8 * 16_384 + 512) == 135_000
    assert fft_ops.friendly_fft_len(16_384 + 512) == 17_280
    assert set(pair_fft.PLANS) == {135_000, 17_280}


CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")


@pytest.mark.parametrize("args,want", [
    ((135_000, CUDA, "phat", 512, 8), "kernels"),
    ((17_280, CUDA, "phat", 512, 4), "kernels"),
    ((135_000, CUDA, "phat", 539, 2), "kernels"),  # 2·539 + 1 = 1079 ≤ N1
    ((135_000, CPU, "phat", 512, 8), "four-step"),  # every CPU tensor
    ((17_280, CPU, "phat", 512, 4), "four-step"),
    ((135_000, CUDA, "scot", 512, 8), "four-step"),  # weightings the kernels do not implement
    ((135_000, CUDA, "roth", 512, 8), "four-step"),
    ((135_000, CUDA, "cc", 512, 8), "four-step"),
    ((67_500, CUDA, "phat", 512, 4), "four-step"),  # lengths no plan covers
    ((270_000, CUDA, "phat", 600, 4), "four-step"),
    ((17_408, CUDA, "phat", 512, 8), "four-step"),
    ((135_000, CUDA, "phat", 600, 4), "four-step"),  # a window wider than N1
    ((135_000, CUDA, "phat", 512, 9), "four-step"),  # more receivers than the max pass takes
])
def test_route(args, want):
    """A pure function of (nfft, device, weighting, max_lag, receivers):
    the same answer twice, no tensor or card needed."""
    nfft, dev, weighting, lag, b = args
    assert pair_fft.route(nfft, dev, weighting, max_lag=lag, num_receivers=b) == want
    assert pair_fft.route(nfft, dev, weighting, max_lag=lag, num_receivers=b) == want


def test_wrappers_reject_what_the_kernels_do_not_take():
    re = torch.zeros(2, 17_281)
    with pytest.raises(ValueError):
        pair_fft.receiver_spectra(re, re, 17_280)  # longer than nfft
    with pytest.raises(ValueError):
        pair_fft.receiver_spectra(re.double(), re.double(), 135_000)
    spec = torch.zeros(6, 16, 1080, 2)
    with pytest.raises(ValueError):
        pair_fft.pair_max(spec, 4)  # 6 rows are not whole channels of 4
    with pytest.raises(ValueError):
        pair_fft.lag_mags(spec, 3, max_lag=540, eps=0.05)  # 2·540 + 1 > 1080


@pytest.mark.parametrize("nfft,length,chans,b", [(135_000, 131_072, 1, 3), (17_280, 16_384, 2, 4)])
def test_plain_versions_match_the_four_step(nfft, length, chans, b):
    """K9's and K10's plain versions (the CPU wrappers) against today's
    ``receiver_spectra_split`` + ``pair_lag_mags`` on the CPU: the same
    windows within 1e-5 of each pair's max, the same integer lags, the
    sub-sample lags within 1e-4 samples."""
    lag, eps = 512, 0.05
    re, im, _ = testing.delayed_noise(chans, b, length, 150, seed=length)
    spec = pair_fft.receiver_spectra(re.reshape(-1, length), im.reshape(-1, length), nfft)
    ours = pair_fft.lag_mags(spec, b, max_lag=lag, eps=eps)
    fr, fi, n = split_complex.receiver_spectra_split(re, im, max_lag=lag)
    assert n == nfft
    pi, pj = gcc_phat.pair_index_tensors(b, CPU)
    ref = gcc_phat.pair_lag_mags(fr, fi, pi, pj, max_lag=lag, eps=eps)
    assert ours.shape == ref.shape == (chans, b * (b - 1) // 2, 2 * lag + 1)
    assert ((ours - ref).abs().amax(-1) / ref.amax(-1)).max().item() <= 1e-5
    torch.testing.assert_close(ours.argmax(-1), ref.argmax(-1))
    pk = lambda m: gcc_phat.peaks_from_lag_mags(m, sample_rate_hz=1.0, max_lag=lag).lag_samples
    torch.testing.assert_close(pk(ours), pk(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["multidwell", "complex"])
def test_pipeline_pair_stage_on_the_kernel_route(monkeypatch, kind):
    """The pipeline's pair stage with the route forced to "kernels" (their
    plain versions on the CPU) against its default CPU route, the
    four-step: the narrowband multi-dwell step (nfft 135000) and the
    complex step (17280). Lags within 1e-4 samples, the same marks."""
    if kind == "multidwell":
        cfg = PipelineConfig(num_buoys=3, block_len=16_384, sample_rate_hz=2.4e6, max_lag=512,
                             correlation_dwells=8)
        re, im, _ = testing.delayed_noise(2, 3, 8 * 16_384, 120, seed=9)
        anchors = torch.from_numpy(np.array([[0, 0, 0], [9e3, 0, 0], [0, 9e3, 0]], np.float32))
        run = lambda pipe, mark: pipe.step_split(re, im, anchors, on_stage=mark)
    else:
        cfg = PipelineConfig(num_buoys=3, block_len=16_384, sample_rate_hz=2.4e6, max_lag=512)
        re, im, _ = testing.delayed_noise(2, 3, 16_384, 120, seed=10)
        anchors = torch.from_numpy(np.array([[0, 0, 0], [9e3, 0, 0], [0, 9e3, 0]], np.float32))
        run = lambda pipe, mark: pipe.step(torch.complex(re, im), anchors, on_stage=mark)
    pipe = TDOAPipeline(cfg, device="cpu")
    outs, marks = {}, {}
    for route in ("four-step", "kernels"):
        monkeypatch.setattr(pair_fft, "route", lambda *a, route=route, **k: route)
        names = []
        outs[route] = run(pipe, names.append)
        marks[route] = names
    assert marks["kernels"] == marks["four-step"]
    assert marks["kernels"].count("spectra") == 1 and "pair_corr" in marks["kernels"]
    a, b = outs["kernels"].correlation, outs["four-step"].correlation
    torch.testing.assert_close(a.lag_samples, b.lag_samples, rtol=0, atol=1e-4)
    torch.testing.assert_close(a.psr, b.psr, rtol=1e-3, atol=0)
