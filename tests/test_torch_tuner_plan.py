"""The port's host register planning (``radio_mapper_tpu_torch.net.tuner_plan``)
against the JAX package's (``radio_mapper_tpu.net.tuner_plan``) on the same
arguments, over a grid of frequencies, sample rates, crystals, ppm and
gains.

Tolerance: exact. The planning is integer and float host arithmetic with
no device in it, so every plan equals the reference's field for field, and
every argument the reference rejects the port rejects with the same
message.
"""

import dataclasses

import numpy as np
import pytest

from radio_mapper_tpu.net import tuner_plan as jtp

from radio_mapper_tpu_torch.net import tuner_plan as tp
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

_rng = np.random.default_rng(18)
FREQS = sorted({*[int(f) for f in _rng.uniform(20e6, 2.3e9, 48)],
                22_000_000, 24_000_000, 88_000_000, 100_000_000, 121_500_000,
                146_000_000, 308_000_000, 438_000_000, 924_000_000, 1_090_000_000,
                1_766_000_000, 2_200_000_000})
RATES = [225_000, 225_001, 250_000, 300_000, 300_001, 900_000, 900_001, 1_024_000,
         1_200_000, 2_048_000, 2_400_000, 2_500_000, 2_560_000, 3_200_000, 3_200_001]
XTALS = [28_800_000, 28_799_000, 16_000_000]
PPMS = [0.0, -12.5, 37.0]


def _both(fn_name, *args, **kw):
    """Call ``fn_name`` in both packages; return both results, or both
    exceptions' class names and messages."""
    out = []
    for mod in (tp, jtp):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except Exception as e:  # compared below, class and message
            out.append((type(e).__name__, str(e)))
    return out


def _fields(x):
    if dataclasses.is_dataclass(x):
        return type(x).__name__, dataclasses.asdict(x)
    return x


def _same(fn_name, *args, **kw):
    ours, ref = _both(fn_name, *args, **kw)
    assert _fields(ours) == _fields(ref), (fn_name, args, kw)
    return ours


def test_constants_and_tables():
    assert tp.DEFAULT_RTL_XTAL_HZ == jtp.DEFAULT_RTL_XTAL_HZ
    assert tp.TWO_POW_22 == jtp.TWO_POW_22
    assert tp.TUNER_GAINS == jtp.TUNER_GAINS
    for name in ("FC0012_BANDS", "FC0013_BANDS"):
        assert getattr(tp, name) == getattr(jtp, name)


@pytest.mark.parametrize("xtal", XTALS)
@pytest.mark.parametrize("ppm", PPMS)
def test_plan_sample_rate(xtal, ppm):
    for r in RATES:
        p = _same("plan_sample_rate", r, xtal_hz=xtal, ppm=ppm)
        if not isinstance(p, tuple):
            assert p.rate_error_ppm == _both("plan_sample_rate", r, xtal_hz=xtal, ppm=ppm)[1].rate_error_ppm


@pytest.mark.parametrize("fn", ["plan_r82xx_pll", "plan_e4k_pll", "plan_fc0012_pll",
                                "plan_fc0013_pll", "plan_fc2580_pll"])
@pytest.mark.parametrize("ppm", PPMS)
def test_pll_plans(fn, ppm):
    xkey = "fosc_hz" if fn == "plan_e4k_pll" else "xtal_hz"
    for xtal in XTALS:
        for f in FREQS:
            p = _same(fn, f, **{xkey: xtal}, ppm=ppm)
            if not isinstance(p, tuple):
                assert p.error_hz == _both(fn, f, **{xkey: xtal}, ppm=ppm)[1].error_hz
    if fn == "plan_r82xx_pll":  # the R828D's VCO power reference
        for f in FREQS[::4]:
            _same(fn, f, ppm=ppm, vco_power_ref=1)


def test_if_offset_and_ppm():
    for xtal in XTALS:
        for ppm in PPMS:
            for f in [0, 1, 3_570_000, 14_400_000, 28_000_000, *FREQS[:8]]:
                _same("plan_if_freq", f, xtal_hz=xtal, ppm=ppm)
                _same("apply_ppm", float(f), ppm)
    for r in RATES:
        _same("offset_tuning_offs_hz", r)


@pytest.mark.parametrize("tuner", ["e4000", "fc0012", "fc0013", "fc2580", "r820t", "r828d",
                                   "R820T", "nosuch"])
def test_nearest_gain(tuner):
    for g in range(-120, 520, 7):
        _same("nearest_gain", g, tuner)


@pytest.mark.parametrize("tuner", ["e4000", "fc0012", "fc0013", "fc2580", "r820t", "r828d", "nosuch"])
def test_plan_capture(tuner):
    for f in FREQS[::3]:
        for r in (1_024_000, 2_048_000, 2_400_000, 500_000):
            for gain in (-50, 0, 280, 496):
                p = _same("plan_capture", f, r, gain_tenth_db=gain, tuner=tuner, ppm=3.0)
                if not isinstance(p, tuple):
                    ref = jtp.plan_capture(f, r, gain_tenth_db=gain, tuner=tuner, ppm=3.0)
                    assert (p.lo_error_hz, p.rate_error_ppm) == (ref.lo_error_hz, ref.rate_error_ppm)
