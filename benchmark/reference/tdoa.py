"""The plain reference of the TDOA step: raw uint8 IQ → peaks, pair lags, fixes.

Plain PyTorch (``torch.fft``, elementwise ops and reductions) written
from the step's published description, for checking what the program
under test returns. It imports nothing of the program and takes nothing
the program made: the raw bytes and the buoy positions the benchmark
synthesised are its only inputs, and it plans its own FFT lengths.

What it computes, per channel-block of ``B`` buoys × ``K·N`` samples:

- decode: ``(u8 − 127.5)`` for I and Q;
- single dwell (``dwells == 1``): the block zero-padded to ``nfft`` (the
  smallest multiple of 1024 ≥ N + max_lag that splits as n1·n2 with n1 a
  multiple of 128 ≤ 1024 and n2 ≤ 1024) and transformed; the detector
  reads the linear power ``|X|²`` in dB; the pair stage whitens
  ``R = X_i·conj(X_j)`` by ``rsqrt(|R|² + ε²·max|X_i|²·max|X_j|²)``
  (the l2rx gate) and inverts it;
- several dwells: the dwell-averaged power spectrum on the N-point grid
  for the detector, and one coherent GCC of the whole capture at the
  smallest 5-smooth length ≥ K·N + max_lag, whitened by
  ``|R| + ε·max|R|`` (the textbook PHAT gate);
- the detector: a circular ±10-bin local maximum, above the threshold,
  outside the ±10 kHz DC notch and at least 6 dB (0.3 × 20 dB) above the
  noise floor, which is the lower median of every 8th bin; the K
  strongest such bins;
- the lag pick: the largest |r| over lags −L..L, a parabola through it
  and its neighbours, the peak-to-sidelobe ratio beyond ±8 lags;
- pair weights ``min(conf_i, conf_j)·(0.1 + 0.9·clip((PSR − 1.2)/2))``
  and a Levenberg-Marquardt solve of the hyperbolic equations in float64
  (the step's algorithm: centroid start, or several starts keeping the
  lowest cost; λ from 1e-3, ×0.3 on a lower cost, ×3 otherwise; Up held).

``tf32=True`` is the control: every transform's operands and results and
every cross power rounded to TF32's 10-bit mantissa, as a tensor-core
TF32 product reads and writes them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SPEED_OF_LIGHT_M_S = 299_792_458.0
UINT8_OFFSET = 127.5
MIN_DISTANCE_BINS = 10
DC_NOTCH_HZ = 10_000.0
CONFIDENCE_FLOOR = 0.3
SNR_FULLSCALE_DB = 20.0
PSR_EXCLUDE = 8
CHUNK_BYTES = 512 << 20  # a chunk's pair spectra (complex64) stay under this


@dataclass(frozen=True)
class Step:
    """The step's settings, as a configuration file states them."""

    num_buoys: int
    block_len: int
    sample_rate_hz: float
    max_lag: int
    max_peaks: int = 8
    gcc_eps: float = 0.05
    detection_threshold_db: float = -70.0
    power_offset_db: float = 0.0
    solver_iterations: int = 40
    solver_starts: int = 1
    noise_floor_stride: int = 8
    psr_floor: float = 1.2
    psr_scale: float = 2.0
    correlation_dwells: int = 1

    @classmethod
    def from_config(cls, pipeline: dict) -> "Step":
        keep = {k: v for k, v in pipeline.items() if k in cls.__dataclass_fields__}
        return cls(**keep)


# -- FFT lengths -------------------------------------------------------------


def ct_nfft(min_len: int) -> int:
    """The single-dwell detection grid: the smallest multiple of 1024 ≥
    ``min_len`` that is n1·n2 with n1 a multiple of 128 up to 1024 and n2
    at most 1024."""
    n = -(-min_len // 1024) * 1024
    while not any(n % n1 == 0 and n // n1 <= 1024 for n1 in range(128, min(n, 1024) + 1, 128)):
        n += 1024
    return n


def smooth_nfft(min_len: int) -> int:
    """The smallest 2^a·3^b·5^c ≥ ``min_len``."""
    best = 1 << (int(min_len) - 1).bit_length()
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p2 = p3
            while p2 < min_len:
                p2 *= 2
            best = min(best, p2)
            p3 *= 3
        p5 *= 5
    return best


# -- rounding of the control -------------------------------------------------


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 (or complex64) rounded to nearest, ties away, at TF32's
    10-bit mantissa."""
    if x.is_complex():
        return torch.complex(tf32(x.real), tf32(x.imag))
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class Precision:
    """The reference (``tf32=False``) or its control (``tf32=True``)."""

    def __init__(self, tf32_control: bool = False):
        self.control = tf32_control

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return tf32(x) if self.control else x

    def fft(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return self.r(torch.fft.fft(self.r(x), n=n, dim=-1))

    def ifft(self, x: torch.Tensor) -> torch.Tensor:
        return self.r(torch.fft.ifft(self.r(x), dim=-1))


# -- detector ----------------------------------------------------------------


def decode(raw: torch.Tensor) -> torch.Tensor:
    """Interleaved uint8 ``[..., 2M]`` → complex64 ``[..., M]``."""
    f = raw.to(torch.float32) - UINT8_OFFSET
    return torch.complex(f[..., 0::2].contiguous(), f[..., 1::2].contiguous())


def sliding_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Circular ±radius running maximum along the last axis."""
    n = x.shape[-1]
    ext = torch.cat([x[..., n - radius:], x, x[..., :radius]], dim=-1)
    pooled = torch.nn.functional.max_pool1d(ext.reshape(-1, 1, ext.shape[-1]), 2 * radius + 1, stride=1)
    return pooled.reshape(x.shape)


def lower_median(x: torch.Tensor) -> torch.Tensor:
    """The ⌈n/2⌉-th smallest value along the last axis."""
    return torch.kthvalue(x, -(-x.shape[-1] // 2), dim=-1).values


@dataclass
class Detection:
    """The reference's detector output for rows ``[R]`` of ``F`` bins."""

    power_db: torch.Tensor  # [R, F] the spectrum the detector reads, dB
    local_max_db: torch.Tensor  # [R, F] its circular ±10-bin running maximum
    floor_db: torch.Tensor  # [R]
    gate_db: torch.Tensor  # [R] the lowest value a candidate may have
    notch: torch.Tensor  # [F] bool, bins inside the DC notch
    top_db: torch.Tensor  # [R, K] descending, −inf where fewer candidates
    top_bins: torch.Tensor  # [R, K] their bins
    cand_db: torch.Tensor  # [R, 2K] the 2K strongest candidates, descending
    cand_bins: torch.Tensor  # [R, 2K] their bins
    confidence: torch.Tensor  # [R] the strongest candidate's confidence, 0 if none


def detect(power_db: torch.Tensor, step: Step, sample_rate_hz: float) -> Detection:
    """The detector on natural-order dB spectra ``[R, F]``."""
    f = power_db.shape[-1]
    floor = lower_median(power_db[..., :: step.noise_floor_stride])
    freqs = torch.fft.fftfreq(f, d=1.0 / sample_rate_hz, dtype=torch.float64).to(power_db.device)
    notch = freqs.abs() < DC_NOTCH_HZ
    lmax = sliding_max(power_db, MIN_DISTANCE_BINS)
    gate = torch.maximum(
        floor + CONFIDENCE_FLOOR * SNR_FULLSCALE_DB,
        torch.full_like(floor, step.detection_threshold_db),
    )
    cand = (power_db >= lmax) & (power_db >= gate.unsqueeze(-1)) & ~notch
    score = torch.where(cand, power_db, float("-inf"))
    cand_db, cand_bins = torch.topk(score, min(2 * step.max_peaks, f), dim=-1)
    top, top_bins = cand_db[..., : step.max_peaks], cand_bins[..., : step.max_peaks]
    conf = torch.clamp((top[..., 0] - floor) / SNR_FULLSCALE_DB, 0.0, 1.0)
    conf = torch.where(torch.isfinite(top[..., 0]), conf, torch.zeros_like(conf))
    return Detection(power_db, lmax, floor, gate, notch, top, top_bins, cand_db, cand_bins, conf)


def block_power_db(x: torch.Tensor, step: Step, p: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    """Single dwell: ``(power dB [R, nfft], spectra [R, nfft])`` of the
    zero-padded rows ``x [R, N]``."""
    nfft = ct_nfft(step.block_len + step.max_lag)
    spec = p.fft(x, nfft)
    lin = p.r(spec.real * spec.real + spec.imag * spec.imag)
    return 10.0 * torch.log10(lin + 1e-24) + step.power_offset_db, spec


def dwell_power_db(x: torch.Tensor, step: Step, p: Precision) -> torch.Tensor:
    """Several dwells: the dwell-averaged power spectrum ``[R, N]`` in dB."""
    k, n = step.correlation_dwells, step.block_len
    spec = p.fft(x.reshape(*x.shape[:-1], k, n), n)
    lin = p.r(spec.real * spec.real + spec.imag * spec.imag)
    return 10.0 * torch.log10(lin.mean(dim=-2) + 1e-24) + step.power_offset_db


# -- pair stage --------------------------------------------------------------


def pair_indices(b: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    i, j = torch.triu_indices(b, b, offset=1, device=device)
    return i, j


def lag_window(spec: torch.Tensor, step: Step, p: Precision, row_max: torch.Tensor | None) -> torch.Tensor:
    """|GCC| at lags −L..L of every pair ``[C, P, 2L+1]`` from receiver
    spectra ``[C, B, nfft]``; ``row_max [C, B]`` (max |X|²) selects the
    l2rx gate, ``None`` the textbook PHAT gate."""
    c, b, nfft = spec.shape
    i, j = pair_indices(b, spec.device)
    x, y = spec[:, i], spec[:, j]
    r = p.r(x * y.conj())
    mag2 = p.r(r.real * r.real + r.imag * r.imag)
    eps = step.gcc_eps
    if row_max is not None:
        s2 = row_max[:, i] * row_max[:, j]
        w = r * torch.rsqrt(mag2 + eps * eps * s2.unsqueeze(-1) + 1e-30)
    else:
        mag = torch.sqrt(mag2)
        w = r / (mag + eps * mag.amax(dim=-1, keepdim=True) + 1e-30)
    corr = p.ifft(w)
    lag = step.max_lag
    window = torch.cat([corr[..., nfft - lag:], corr[..., : lag + 1]], dim=-1)
    return window.abs()


def parabola(m: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Sub-sample offset of the parabola through m[k−1], m[k], m[k+1];
    0 at the window's edges or on a flat fit."""
    n = m.shape[-1]
    kc = k.clamp(1, n - 2)
    ym1 = m.gather(-1, (kc - 1).unsqueeze(-1)).squeeze(-1)
    y0 = m.gather(-1, kc.unsqueeze(-1)).squeeze(-1)
    yp1 = m.gather(-1, (kc + 1).unsqueeze(-1)).squeeze(-1)
    den = ym1 - 2.0 * y0 + yp1
    flat = den.abs() < 1e-12
    d = torch.clamp(0.5 * (ym1 - yp1) / torch.where(flat, torch.ones_like(den), den), -0.999, 0.999)
    d = torch.where(flat, torch.zeros_like(d), d)
    return torch.where((k >= 1) & (k <= n - 2), d, torch.zeros_like(d))


def psr(m: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Peak over the largest magnitude more than 8 lags from it."""
    idx = torch.arange(m.shape[-1], device=m.device)
    far = (idx - k.unsqueeze(-1)).abs() > PSR_EXCLUDE
    side = torch.where(far, m, torch.full_like(m, float("-inf"))).amax(dim=-1)
    return m.gather(-1, k.unsqueeze(-1)).squeeze(-1) / (side.clamp(min=0.0) + 1e-12)


def pair_weights(conf: torch.Tensor, psr_v: torch.Tensor, step: Step) -> torch.Tensor:
    """``conf [..., B]``, ``psr [..., P]`` → weights ``[..., P]``."""
    i, j = pair_indices(conf.shape[-1], conf.device)
    q = 0.1 + 0.9 * torch.clamp((psr_v - step.psr_floor) / step.psr_scale, 0.0, 1.0)
    return torch.minimum(conf[..., i], conf[..., j]) * q


# -- solve -------------------------------------------------------------------


def _cost(x, anchors, i, j, dd, w, wsum):
    dist = torch.linalg.vector_norm(x.unsqueeze(-2) - anchors, dim=-1)
    r = dist[..., i] - dist[..., j] - dd
    return (w * r * r).sum(-1) / wsum


def weighted_cost(anchors: torch.Tensor, tau_s: torch.Tensor, weights: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """The solve's objective at ``x [..., 3]`` in float64: the weighted mean
    squared residual of the hyperbolic equations (m²), with all-zero
    weights taken as uniform, as the solve takes them."""
    f64 = torch.float64
    anchors, x = anchors.to(f64), x.to(f64)
    dd = tau_s.to(f64) * SPEED_OF_LIGHT_M_S
    w = weights.to(f64).clamp(min=0.0)
    w = torch.where(w.sum(-1, keepdim=True) > 1e-9, w, torch.ones_like(w))
    i, j = pair_indices(anchors.shape[-2], dd.device)
    return _cost(x, anchors, i, j, dd, w, w.sum(-1) + 1e-12)


def lm_solve(anchors: torch.Tensor, dd: torch.Tensor, weights: torch.Tensor, step: Step,
             start: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-Marquardt in float64 from ``start [..., 3]``: ``(position
    [..., 3], cost [...])``; ``anchors [B, 3]``, ``dd, weights [..., P]``."""
    f64 = torch.float64
    anchors, dd, w = anchors.to(f64), dd.to(f64), weights.to(f64).clamp(min=0.0)
    i, j = pair_indices(anchors.shape[-2], dd.device)
    w = torch.where(w.sum(-1, keepdim=True) > 1e-9, w, torch.ones_like(w))
    wsum = w.sum(-1) + 1e-12
    mask = torch.tensor([1.0, 1.0, 0.0], dtype=f64, device=dd.device)
    x = start.to(f64).expand(*dd.shape[:-1], 3).clone()
    lam = torch.full(dd.shape[:-1], 1e-3, dtype=f64, device=dd.device)
    cost = _cost(x, anchors, i, j, dd, w, wsum)
    eye = torch.eye(3, dtype=f64, device=dd.device)
    for _ in range(step.solver_iterations):
        diff = x.unsqueeze(-2) - anchors
        dist = torch.linalg.vector_norm(diff, dim=-1)
        unit = diff / (dist.unsqueeze(-1) + 1e-9)
        r = dist[..., i] - dist[..., j] - dd
        jac = (unit[..., i, :] - unit[..., j, :]) * mask
        g = torch.einsum("...pk,...p->...k", jac, w * r) / wsum.unsqueeze(-1)
        h = torch.einsum("...pk,...pl->...kl", jac, jac * w.unsqueeze(-1)) / wsum[..., None, None]
        damp = lam.unsqueeze(-1) * torch.diagonal(h, dim1=-2, dim2=-1).clamp(min=1e-6) + 1e-6
        delta = torch.linalg.solve(h + eye * damp.unsqueeze(-2), -g.unsqueeze(-1)).squeeze(-1)
        x_new = x + delta * mask
        c_new = _cost(x_new, anchors, i, j, dd, w, wsum)
        better = c_new < cost
        x = torch.where(better.unsqueeze(-1), x_new, x)
        lam = torch.clamp(torch.where(better, lam * 0.3, lam * 3.0), 1e-8, 1e8)
        cost = torch.minimum(cost, c_new)
    return x, cost


def solve(anchors: torch.Tensor, tau_s: torch.Tensor, weights: torch.Tensor, step: Step) -> torch.Tensor:
    """The fix ``[..., 3]``: one start at the buoys' centroid, or several
    (the centroid, then 2.5× out towards buoy 0, 1, …) keeping the lowest
    final cost, the first start among equals."""
    anchors = anchors.to(torch.float64)
    centroid = anchors.mean(dim=0)
    dd = tau_s.to(torch.float64) * SPEED_OF_LIGHT_M_S
    starts = [centroid] + [
        centroid + 2.5 * (anchors[(s - 1) % anchors.shape[0]] - centroid) for s in range(1, step.solver_starts)
    ]
    best_x, best_c = None, None
    for s in starts:
        x, c = lm_solve(anchors, dd, weights, step, s)
        c = torch.where(torch.isnan(c), torch.full_like(c, float("-inf")), c)
        if best_x is None:
            best_x, best_c = x, c
        else:
            take = c < best_c
            best_x = torch.where(take.unsqueeze(-1), x, best_x)
            best_c = torch.where(take, c, best_c)
    return best_x


# -- the whole step ------------------------------------------------------------


def pair_nfft(step: Step) -> int:
    """The pair stage's transform length."""
    if step.correlation_dwells == 1:
        return ct_nfft(step.block_len + step.max_lag)
    return smooth_nfft(step.correlation_dwells * step.block_len + step.max_lag)


def chunk_blocks(step: Step) -> int:
    """Channel-blocks a chunk of :func:`reference_chunk` holds."""
    b = step.num_buoys
    return max(1, CHUNK_BYTES // (b * (b - 1) // 2 * pair_nfft(step) * 8))


def lag_at(m: torch.Tensor, k: torch.Tensor, step: Step) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sub-sample lag in samples, float64; PSR)`` of windows ``m`` at
    integer lag indices ``k``."""
    lag = k.to(torch.float64) - step.max_lag + parabola(m, k).to(torch.float64)
    return lag, psr(m, k)


@dataclass
class StepResult:
    """The reference's step on ``C`` channel-blocks of ``B`` buoys."""

    detection: Detection  # rows [C·B]
    window: torch.Tensor  # [C, P, 2L+1] |GCC| at lags −L..L
    pick: torch.Tensor  # [C, P] int64, the index of the largest |r|
    lag: torch.Tensor  # [C, P] float64 sub-sample lag (samples)
    psr: torch.Tensor  # [C, P]
    weights: torch.Tensor  # [C, P]
    fix: torch.Tensor  # [C, 3] float64


def reference_chunk(raw: torch.Tensor, anchors: torch.Tensor, step: Step, p: Precision) -> StepResult:
    """The whole step on raw uint8 channel-blocks ``[C, B, 2·K·N]``: decode,
    spectra, detection, the pair windows, its own lag picks, weights and
    the LM solve."""
    b = step.num_buoys
    x = decode(raw)
    c = x.shape[0]
    if step.correlation_dwells == 1:
        pdb, spec = block_power_db(x.reshape(c * b, -1), step, p)
        row_max = p.r(spec.real * spec.real + spec.imag * spec.imag).amax(dim=-1).reshape(c, b)
        spec = spec.reshape(c, b, -1)
    else:
        pdb = dwell_power_db(x.reshape(c * b, -1), step, p)
        spec, row_max = p.fft(x, pair_nfft(step)), None
    del x
    det = detect(pdb, step, step.sample_rate_hz)
    m = lag_window(spec, step, p, row_max)
    del spec
    k = m.argmax(dim=-1)
    lag, psr_v = lag_at(m, k, step)
    w = pair_weights(det.confidence.reshape(c, b), psr_v, step)
    fix = solve(anchors, lag / step.sample_rate_hz, w, step)
    return StepResult(det, m, k, lag, psr_v, w, fix)
