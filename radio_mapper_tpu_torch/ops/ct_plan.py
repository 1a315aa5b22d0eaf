"""Numpy planning tables for the four-step (Cooley-Tukey) transforms.

These tables are this system's "weights": the DFT and twiddle matrices,
the FFT length planner and the detection thresholds. They are computed
with the same numpy code as the JAX package (``ops/pallas/fft_kernel.py``
``ct_split``/``ct_constants``/``ct_permutation``, ``gcc_kernel.plan_nfft``,
``detect_kernel.notch_keep_range``/``_detect_plan``), and a test asserts
they are bit-identical.

CT bin order: a length-n = n1·n2 row is viewed as ``x[q, p]`` at time
``q·n1 + p``; the forward transform emits bin ``k = k2 + n2·k1`` at flat
address ``m = k2·n1 + k1``. The inverse consumes that order and emits
natural time order, so the permutation cancels through the pair stage.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

SEGMENT = 8  # natural bins per detection partial; must divide n2
LN10_OVER_10 = math.log(10.0) / 10.0  # dB → natural-log scale of linear power


def ct_split(n: int) -> Tuple[int, int]:
    """(n1, n2) with n = n1·n2, n1 a multiple of 128 minimizing n1+n2,
    preferring n2 ≡ 0 (mod 8). Raises ValueError when no such split exists."""
    best = None  # (misaligned, n1+n2, n1, n2) — lexicographic preference
    n1 = 128
    while n1 <= min(n, 1024):
        if n % n1 == 0:
            n2 = n // n1
            if n2 <= 1024:
                key = (n2 % 8 != 0, n1 + n2, n1, n2)
                if best is None or key < best:
                    best = key
        n1 += 128
    if best is None:
        raise ValueError(f"no lane-aligned factorization for FFT length {n}")
    return best[2], best[3]


def ct_supported(n: int) -> bool:
    try:
        ct_split(n)
        return True
    except ValueError:
        return False


@functools.lru_cache(maxsize=16)
def ct_constants(n: int, inverse: bool = False):
    """``(n1, n2, w1re, w1im, w2re, w2im, twre, twim)`` float32 tables.

    ``w1`` is the n1-point DFT matrix, ``w2`` the n2-point one, ``tw[k2, p]``
    the twiddle ``W_n^{k2·p}``; conjugated for the inverse (the 1/n scale
    is applied by the caller).
    """
    n1, n2 = ct_split(n)
    sign = 2j if inverse else -2j
    w1 = np.exp(sign * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    w2 = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(sign * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)  # [k2, p]
    f32 = lambda a: a.astype(np.float32)
    return (
        n1, n2,
        f32(w1.real), f32(w1.imag),
        f32(w2.real), f32(w2.imag),
        f32(tw.real), f32(tw.imag),
    )


class DeviceTables(NamedTuple):
    """:func:`ct_constants` on a device, as separate planes for the plain
    versions and as interleaved (re, im) pairs — CUDA ``float2`` — for the
    kernels."""

    w1re: torch.Tensor  # [n1, n1]
    w1im: torch.Tensor
    w2re: torch.Tensor  # [n2, n2]
    w2im: torch.Tensor
    twre: torch.Tensor  # [n2, n1]
    twim: torch.Tensor
    w1: torch.Tensor  # [n1, n1, 2]
    w2: torch.Tensor  # [n2, n2, 2]
    tw: torch.Tensor  # [n2, n1, 2]


@functools.lru_cache(maxsize=16)
def device_tables(n: int, inverse: bool, device: torch.device) -> DeviceTables:
    _, _, w1re, w1im, w2re, w2im, twre, twim = ct_constants(n, inverse)
    t = lambda a: torch.from_numpy(a).to(device)
    pair = lambda re, im: torch.from_numpy(np.stack([re, im], axis=-1)).to(device)
    return DeviceTables(
        t(w1re), t(w1im), t(w2re), t(w2im), t(twre), t(twim),
        pair(w1re, w1im), pair(w2re, w2im), pair(twre, twim),
    )


def ct_permutation(n: int) -> np.ndarray:
    """perm with X_ct[m] = X_natural[perm[m]]."""
    n1, n2 = ct_split(n)
    k2 = np.arange(n2)[:, None]
    k1 = np.arange(n1)[None, :]
    return (k2 + n2 * k1).reshape(-1)  # index m = k2*n1 + k1 row-major


def plan_nfft(min_len: int) -> int:
    """Smallest multiple of 1024 ≥ ``min_len`` with a CT split.

    Multiples of 1024 give n1 ≡ 0 (mod 128) and n2 ≡ 0 (mod 8); the
    detection's ``bin_index`` lives on this grid, so the port keeps it.
    """
    n = -(-min_len // 1024) * 1024
    while not ct_supported(n):  # pragma: no cover — n2 > 1024
        n += 1024
    return n


def notch_keep_range(
    nfft: int, sample_rate_hz: float, dc_notch_hz: Optional[float]
) -> Tuple[int, int]:
    """[keep_lo, keep_hi] natural-bin range surviving the DC notch."""
    if dc_notch_hz is None:
        return 0, nfft - 1
    freqs = np.fft.fftfreq(nfft, d=1.0 / sample_rate_hz)
    mask = np.abs(freqs) >= dc_notch_hz
    kept = np.flatnonzero(mask)
    if kept.size == 0:
        return 1, 0  # empty range: notch swallows every bin
    return int(kept[0]), int(kept[-1])


@dataclasses.dataclass(frozen=True)
class DetectPlan:
    """Static parameters of the fused FFT + detect stage (kernel K1)."""

    nfft: int
    n1: int
    n2: int
    radius: int  # ± sliding-max half-width in natural bins
    thr_lin: float  # linear-power height threshold (inf: nothing passes)
    keep_lo: int  # DC-notch keep range, natural bins, inclusive
    keep_hi: int
    conf_cs: Optional[float]  # confidence_floor·snr_fullscale_db, None = no gate
    power_offset_db: float
    bisect_iters: int

    @property
    def segments(self) -> int:
        return self.nfft // SEGMENT


def detect_plan(
    nfft: int,
    *,
    sample_rate_hz: float,
    threshold_db: float,
    min_distance_bins: int,
    dc_notch_hz: Optional[float],
    confidence_floor: float,
    snr_fullscale_db: float,
    power_offset_db: float = 0.0,
    bisect_iters: int = 24,
) -> DetectPlan:
    """Validate and derive the detection parameters (``_detect_plan``).

    Comparisons run in linear power: ``thr_lin = 10^((thr − off)/10)``;
    a confidence floor above 1 can never pass, so it becomes an infinite
    threshold (the noise floor is still computed and reported).
    """
    n1, n2 = ct_split(nfft)
    if n2 % SEGMENT != 0:
        raise ValueError(f"nfft {nfft}: n2 {n2} not a multiple of {SEGMENT}")
    if min_distance_bins + 1 < SEGMENT:
        raise ValueError(
            f"min_distance_bins {min_distance_bins} < {SEGMENT - 1} breaks "
            "segment exactness"
        )
    if n2 < min_distance_bins:
        raise ValueError(
            f"nfft {nfft}: column height n2={n2} < radius {min_distance_bins}"
        )
    thr_lin = float(10.0 ** ((threshold_db - power_offset_db) / 10.0))
    if confidence_floor > 1.0:
        thr_lin = float("inf")
        conf_cs = None
    else:
        conf_cs = (
            confidence_floor * snr_fullscale_db if confidence_floor > 0.0 else None
        )
    keep_lo, keep_hi = notch_keep_range(nfft, sample_rate_hz, dc_notch_hz)
    return DetectPlan(
        nfft=nfft, n1=n1, n2=n2,
        radius=min_distance_bins,
        thr_lin=thr_lin, keep_lo=keep_lo, keep_hi=keep_hi,
        conf_cs=conf_cs, power_offset_db=power_offset_db,
        bisect_iters=bisect_iters,
    )

