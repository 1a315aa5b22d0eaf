"""The least-work counts of the stages with a roofline, against hand counts."""

from __future__ import annotations

import math

import pytest
from conftest import BENCH

from harness import manifest, peaks

FLAG = dict(num_buoys=8, block_len=16384, max_lag=512, correlation_dwells=1)
NARROW = dict(num_buoys=8, block_len=16384, max_lag=512, correlation_dwells=8)


def _least(stage, pipeline, lead):
    return manifest.work(stage, BENCH).least(pipeline, lead)


def test_fft_detect_flagship_dispatch():
    rows = 64 * 128 * 8
    nfft = 17408  # 16384 + 512 → 17 × 1024 = 128 · 136
    flops, nbytes = _least("fft_detect", FLAG, (64, 128))
    assert flops == pytest.approx(rows * (5 * nfft * math.log2(nfft) + 6 * nfft))
    assert nbytes == rows * (8 * 16384 + 8 * nfft + 8 * 2176 + 8)


def test_gcc_pair_flagship_dispatch():
    pairs = 64 * 128 * 28
    flops, nbytes = _least("gcc_pair", FLAG, (64, 128))
    assert flops == pytest.approx(pairs * (6 * 17408 + 5 * 17408 * math.log2(1025) + 3 * 1025))
    assert nbytes == 64 * 128 * 8 * (8 * 17408 + 4) + pairs * 16


def test_psd_narrowband_dispatch():
    rows = 128 * 8
    flops, nbytes = _least("psd", NARROW, (128,))
    assert flops == pytest.approx(rows * 8 * (5 * 16384 * 14 + 4 * 16384))
    assert nbytes == rows * (8 * 131072 + 4 * 16384)


def test_pair_corr_narrowband_dispatch():
    nfft = 135000  # 2^3 · 3^3 · 5^4 ≥ 131072 + 512
    flops, nbytes = _least("pair_corr", NARROW, (128,))
    hand = 128 * 8 * 5 * nfft * math.log2(nfft) + 128 * 28 * (6 * nfft + 5 * nfft * math.log2(1025) + 3 * 1025)
    assert flops == pytest.approx(hand)
    assert nbytes == 128 * 8 * 8 * 131072 + 128 * 28 * 4 * 1025


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(495e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds(495e12, 6.7e12) == pytest.approx(2.0)
