"""Host-side RTL-SDR register planning — librtlsdr's frequency math.

The reference's librtlsdr computes, on the host, exactly what the
hardware will actually do with a requested setting: the RTL2832U's
rational resampler quantizes the sample rate
(`Code/src/librtlsdr.c:1075-1126`), the tuner PLL's sigma-delta
modulator quantizes the LO frequency (R82xx:
`Code/src/tuner_r82xx.c:417-552`; E4000: `Code/src/tuner_e4k.c:481-531`),
and gains snap to per-tuner tables (`Code/src/librtlsdr.c:963-997`,
`nearest_gain` `Code/src/convenience/convenience.c:112-137`).

This framework drives dongles through the rtl_tcp wire protocol (the
dongle host's firmware applies these equations), but the *planning* math
still belongs here: the achieved sample rate — not the requested one —
converts GCC-PHAT lags into meters, and the achieved LO sets the
inter-node frequency offset budget for coherent correlation. A 2.048 MS/s
request is actually honored exactly; 2.4 MS/s quantizes to a few mHz off;
ppm crystal error scales everything.

All functions are pure integer/float host math (no device required) and
reproduce the reference register arithmetic bit-exactly.

Port of ``radio_mapper_tpu/net/tuner_plan.py``: a copy, so every plan
equals the JAX package's field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

# --- RTL2832U rational resampler (`librtlsdr.c:1075-1126`) -----------------

DEFAULT_RTL_XTAL_HZ = 28_800_000  # `librtlsdr.c` DEF_RTL_XTAL_FREQ
TWO_POW_22 = 1 << 22


class PlanError(ValueError):
    pass


def apply_ppm(freq_hz: float, ppm: float) -> float:
    """Crystal-error correction (`librtlsdr.c:773`)."""
    return freq_hz * (1.0 + ppm / 1e6)


@dataclasses.dataclass(frozen=True)
class SampleRatePlan:
    requested_hz: float
    rsamp_ratio: int          # value written to demod regs 0x9f/0xa1
    real_rate_hz: float       # what the resampler actually produces
    xtal_hz: float

    @property
    def rate_error_ppm(self) -> float:
        return (self.real_rate_hz / self.requested_hz - 1.0) * 1e6


def plan_sample_rate(
    samp_rate_hz: float,
    *,
    xtal_hz: float = DEFAULT_RTL_XTAL_HZ,
    ppm: float = 0.0,
) -> SampleRatePlan:
    """Resampler ratio + achieved rate (`rtlsdr_set_sample_rate`,
    `librtlsdr.c:1086-1098`). Raises on rates the chip rejects."""
    r = int(samp_rate_hz)
    if r <= 225_000 or r > 3_200_000 or (300_000 < r <= 900_000):
        raise PlanError(
            f"invalid sample rate {r} Hz: RTL2832U accepts (225k, 300k] "
            "and (900k, 3.2M] only (librtlsdr.c:1086-1090)"
        )
    # The ratio registers are programmed from the NOMINAL crystal
    # (`librtlsdr.c:1092` uses dev->rtl_xtal); a crystal running ppm off
    # scales the physical output rate proportionally. (librtlsdr's
    # separate fine-correction register can cancel this when a ppm
    # calibration is programmed; we model the uncorrected dongle, which
    # is the TDOA error budget's worst case.)
    rsamp_ratio = int(xtal_hz * TWO_POW_22) // r
    rsamp_ratio &= 0x0FFFFFFC
    real_ratio = rsamp_ratio | ((rsamp_ratio & 0x08000000) << 1)
    true_xtal = apply_ppm(xtal_hz, ppm)
    real_rate = (true_xtal * TWO_POW_22) / real_ratio
    return SampleRatePlan(
        requested_hz=samp_rate_hz, rsamp_ratio=rsamp_ratio,
        real_rate_hz=real_rate, xtal_hz=true_xtal,
    )


# --- R82xx PLL (`tuner_r82xx.c:417-552`) ------------------------------------

R82XX_VCO_MIN_KHZ = 1_770_000
R82XX_VCO_MAX_KHZ = 2 * R82XX_VCO_MIN_KHZ
R82XX_SDM_DENOM = 65_536


@dataclasses.dataclass(frozen=True)
class PllPlan:
    requested_hz: int
    actual_hz: float
    # register-level quantities, for tests / debugging
    params: Dict[str, int]

    @property
    def error_hz(self) -> float:
        return self.actual_hz - self.requested_hz


def plan_r82xx_pll(
    freq_hz: float,
    *,
    xtal_hz: float = DEFAULT_RTL_XTAL_HZ,
    ppm: float = 0.0,
    vco_power_ref: int = 2,  # 1 for R828D (`tuner_r82xx.c:473-474`)
) -> PllPlan:
    """R820T/R828D LO plan: mixer divider, integer-N, and 16-bit
    sigma-delta fraction (`r82xx_set_pll`, `tuner_r82xx.c:417-552`).

    Achieved LO = 2·f_ref·(nint + sdm/65536)/mix_div — the sdm
    quantization is the tuner's intrinsic frequency granularity
    (~879 Hz/LSB at 28.8 MHz xtal, divider-dependent).
    """
    freq = int(freq_hz)
    pll_ref = int(apply_ppm(xtal_hz, ppm))
    freq_khz = (freq + 500) // 1000
    pll_ref_khz = (pll_ref + 500) // 1000

    mix_div = 2
    while mix_div <= 64:
        if R82XX_VCO_MIN_KHZ <= freq_khz * mix_div < R82XX_VCO_MAX_KHZ:
            break
        mix_div <<= 1
    else:
        raise PlanError(f"{freq} Hz outside R82xx VCO divider range")

    vco_freq = freq * mix_div
    nint = vco_freq // (2 * pll_ref)
    vco_fra = (vco_freq - 2 * pll_ref * nint) // 1000  # kHz

    if nint > (128 // vco_power_ref) - 1:
        raise PlanError(f"no valid R82xx PLL values for {freq} Hz "
                        "(tuner_r82xx.c:491-494)")
    ni = (nint - 13) // 4
    si = nint - 4 * ni - 13

    # sigma-delta accumulation exactly as `tuner_r82xx.c:514-524`
    sdm = 0
    n_sdm = 2
    while vco_fra > 1:
        if vco_fra > (2 * pll_ref_khz) // n_sdm:
            sdm += 32768 // (n_sdm // 2)
            vco_fra -= (2 * pll_ref_khz) // n_sdm
            if n_sdm >= 0x8000:
                break
        n_sdm <<= 1

    actual_vco = 2 * pll_ref * nint + (2 * pll_ref * sdm) / R82XX_SDM_DENOM
    actual = actual_vco / mix_div
    return PllPlan(
        requested_hz=freq, actual_hz=actual,
        params={"mix_div": mix_div, "nint": nint, "ni": ni, "si": si,
                "sdm": sdm, "pll_ref": pll_ref},
    )


# --- E4000 PLL (`tuner_e4k.c:353-531`) --------------------------------------

# (upper freq bound kHz, reg_synth7, R multiplier) — `tuner_e4k.c:359-370`
E4K_PLL_VARS: Tuple[Tuple[int, int, int], ...] = (
    (72_400, (1 << 3) | 7, 48),
    (81_200, (1 << 3) | 6, 40),
    (108_300, (1 << 3) | 5, 32),
    (162_500, (1 << 3) | 4, 24),
    (216_600, (1 << 3) | 3, 16),
    (325_000, (1 << 3) | 2, 12),
    (350_000, (1 << 3) | 1, 8),
    (432_000, (0 << 3) | 3, 8),
    (667_000, (0 << 3) | 2, 6),
    (1_200_000, (0 << 3) | 1, 4),
)
E4K_PLL_Y = 65_536
E4K_FVCO_MIN_KHZ = 2_600_000
E4K_FVCO_MAX_KHZ = 3_900_000


def plan_e4k_pll(
    freq_hz: float,
    *,
    fosc_hz: float = DEFAULT_RTL_XTAL_HZ,
    ppm: float = 0.0,
) -> PllPlan:
    """E4000 LO plan (`e4k_compute_pll_params`, `tuner_e4k.c:481-531`):
    R from the band table, integer Z, 16-bit fractional X;
    flo = fosc·(z + x/65536)/r."""
    freq = int(freq_hz)
    fosc = int(apply_ppm(fosc_hz, ppm))
    for upper_khz, r_idx, r in E4K_PLL_VARS:
        if freq < upper_khz * 1000:
            break
    else:
        # Above the table (>1.2 GHz) the C code keeps its initializers
        # r=2, r_idx=0 (`tuner_e4k.c:484, 490`).
        r, r_idx = 2, 0

    fvco = freq * r
    if not (E4K_FVCO_MIN_KHZ <= fvco // 1000 <= E4K_FVCO_MAX_KHZ):
        raise PlanError(f"E4K Fvco {fvco} invalid (tuner_e4k.c:373-380)")
    z = fvco // fosc
    if z > 255:
        raise PlanError("E4K Z out of range")
    remainder = fvco - fosc * z
    x = (remainder * E4K_PLL_Y) // fosc
    # compute_flo (`tuner_e4k.c:425-440`)
    actual = (fosc * z + (fosc * x) // E4K_PLL_Y) / r
    return PllPlan(
        requested_hz=freq, actual_hz=actual,
        params={"r": r, "r_idx": r_idx, "z": z, "x": x, "fosc": fosc},
    )


# --- FC0012 / FC0013 sigma-delta PLL (`tuner_fc0012.c:150-255`,
# ---                                  `tuner_fc0013.c:194-352`) -------------

# (upper bound Hz, VCO multiplier) — `tuner_fc0012.c:160-200`
FC0012_BANDS: Tuple[Tuple[int, int], ...] = (
    (37_084_000, 96), (55_625_000, 64), (74_167_000, 48),
    (111_250_000, 32), (148_334_000, 24), (222_500_000, 16),
    (296_667_000, 12), (445_000_000, 8), (593_334_000, 6),
)
# FC0013 extends the table down to ÷2 (`tuner_fc0013.c:259-305`)
FC0013_BANDS: Tuple[Tuple[int, int], ...] = FC0012_BANDS + ((950_000_000, 4),)


def _plan_fc001x_pll(
    freq_hz: float, bands, last_multi: int, *, xtal_hz: float, ppm: float, chip: str
) -> PllPlan:
    """Shared FC0012/FC0013 plan: count-to-8/9 main divider + 16-bit
    sigma-delta fraction with kHz-granular computation
    (`tuner_fc0012.c:203-245`). Achieved LO =
    (xtal/2)·(⌊xdiv⌋ + xin/32768)/multi — the kHz truncation in the C
    code's xin math is the dominant quantization (~sub-kHz at VCO)."""
    freq = int(freq_hz)
    xtal_div2 = int(apply_ppm(xtal_hz, ppm)) // 2
    for upper, multi in bands:
        if freq < upper:
            break
    else:
        multi = last_multi
    f_vco = freq * multi

    xdiv = f_vco // xtal_div2
    if (f_vco - xdiv * xtal_div2) >= (xtal_div2 // 2):
        xdiv += 1
    pm, am = xdiv // 8, xdiv % 8
    if am < 2:
        am += 8
        pm -= 1
    if pm > 31:
        reg1, reg2 = am + 8 * (pm - 31), 31
    else:
        reg1, reg2 = am, pm
    if reg1 > 15 or reg2 < 0x0B:
        raise PlanError(
            f"no valid {chip.upper()} PLL combination for {freq} Hz "
            "(tuner_fc0012.c:231-235)"
        )

    # Fractional part in kHz resolution, 15-bit scale, sign-wrapped when
    # xdiv was rounded up (`tuner_fc0012.c:241-245`).
    floor_xdiv = f_vco // xtal_div2
    xin = ((f_vco - floor_xdiv * xtal_div2) // 1000) << 15
    xin //= xtal_div2 // 1000
    xin_stored = xin + 32768 if xin >= 16384 else xin
    # Effective divider = floor + xin/32768 regardless of the wrap (the
    # wrap encodes the same fraction relative to the rounded xdiv).
    actual_vco = xtal_div2 * floor_xdiv + (xtal_div2 * xin) // 32768
    actual = actual_vco / multi
    return PllPlan(
        requested_hz=freq, actual_hz=actual,
        params={"multi": multi, "xdiv": xdiv, "pm": pm, "am": am,
                "reg1": reg1, "reg2": reg2, "xin": xin_stored,
                "vco_select": int(f_vco >= 3_060_000_000),
                "xtal_div2": xtal_div2},
    )


def plan_fc0012_pll(freq_hz: float, *, xtal_hz: float = DEFAULT_RTL_XTAL_HZ,
                    ppm: float = 0.0) -> PllPlan:
    return _plan_fc001x_pll(freq_hz, FC0012_BANDS, 4,
                            xtal_hz=xtal_hz, ppm=ppm, chip="fc0012")


def plan_fc0013_pll(freq_hz: float, *, xtal_hz: float = DEFAULT_RTL_XTAL_HZ,
                    ppm: float = 0.0) -> PllPlan:
    return _plan_fc001x_pll(freq_hz, FC0013_BANDS, 2,
                            xtal_hz=xtal_hz, ppm=ppm, chip="fc0013")


# --- FC2580 fractional-N PLL (`tuner_fc2580.c:195-230`) ---------------------


def plan_fc2580_pll(freq_hz: float, *, xtal_hz: float = DEFAULT_RTL_XTAL_HZ,
                    ppm: float = 0.0) -> PllPlan:
    """FC2580 LO plan (kHz-domain math like the C code): band multiplier
    (VHF ×12 / UHF ×4 / L ×2), reference divider R ∈ {1,2,4}, 20-bit
    fractional K. Achieved LO = 2·f_comp·(N + K/2^20)/multi."""
    f_lo = int(freq_hz) // 1000  # the C API works in kHz
    freq_xtal = int(apply_ppm(xtal_hz, ppm)) // 1000
    if f_lo > 1_000_000:
        band, multi = "l", 2
    elif f_lo > 400_000:
        band, multi = "uhf", 4
    else:
        band, multi = "vhf", 12
    f_vco = f_lo * multi
    r_val = 1 if f_vco >= 2 * 76 * freq_xtal else (2 if f_vco >= 76 * freq_xtal else 4)
    f_comp = freq_xtal // r_val
    n_val = (f_vco // 2) // f_comp
    f_diff = f_vco - 2 * f_comp * n_val
    pre_shift = 4
    f_diff_shifted = f_diff << (20 - pre_shift)
    k_val = f_diff_shifted // ((2 * f_comp) >> pre_shift)
    if f_diff_shifted - k_val * ((2 * f_comp) >> pre_shift) >= (f_comp >> pre_shift):
        k_val += 1
    actual_khz = 2 * f_comp * (n_val + k_val / (1 << 20)) / multi
    return PllPlan(
        requested_hz=int(freq_hz), actual_hz=actual_khz * 1000.0,
        params={"band": {"vhf": 0, "uhf": 1, "l": 2}[band], "multi": multi,
                "r_val": r_val, "f_comp": f_comp, "n_val": n_val,
                "k_val": k_val},
    )


# --- RTL2832U IF down-converter + offset tuning (`librtlsdr.c:690-714,
# --- 1135-1258`) -------------------------------------------------------------


def plan_if_freq(if_hz: float, *, xtal_hz: float = DEFAULT_RTL_XTAL_HZ,
                 ppm: float = 0.0) -> float:
    """Achieved RTL2832U digital IF: the 22-bit ratio register quantizes
    the requested IF (`rtlsdr_set_if_freq`, `librtlsdr.c:704`). Used for
    direct-sampling tuning and offset-tuning compensation."""
    xtal = apply_ppm(xtal_hz, ppm)
    reg = int((int(if_hz) * TWO_POW_22) // int(xtal))  # truncating, as the C does
    return reg * xtal / TWO_POW_22


def offset_tuning_offs_hz(rate_hz: float) -> int:
    """Offset-tuning LO shift: (rate/2)·1.7 (`librtlsdr.c:1237`, keenerd's
    1/f-noise measurement) — moves the zero-IF DC spur out of band for
    non-R82xx tuners; the 2832's IF stage shifts it back digitally."""
    return (int(rate_hz) // 2) * 170 // 100


# --- Gain tables + quantization (`librtlsdr.c:960-1010`) --------------------

# tenths of a dB, per `rtlsdr_get_tuner_gains` (`librtlsdr.c:963-974`)
TUNER_GAINS: Dict[str, Tuple[int, ...]] = {
    "e4000": (-10, 15, 40, 65, 90, 115, 140, 165, 190, 215,
              240, 290, 340, 420),
    "fc0012": (-99, -40, 71, 179, 192),
    "fc0013": (-99, -73, -65, -63, -60, -58, -54, 58, 61,
               63, 65, 67, 68, 70, 71, 179, 181, 182,
               184, 186, 188, 191, 197),
    "fc2580": (0,),
    "r820t": (0, 9, 14, 27, 37, 77, 87, 125, 144, 157,
              166, 197, 207, 229, 254, 280, 297, 328,
              338, 364, 372, 386, 402, 421, 434, 439,
              445, 480, 496),
    "r828d": (0, 9, 14, 27, 37, 77, 87, 125, 144, 157,
              166, 197, 207, 229, 254, 280, 297, 328,
              338, 364, 372, 386, 402, 421, 434, 439,
              445, 480, 496),
}


def nearest_gain(target_tenth_db: int, tuner: str = "r820t") -> int:
    """Snap a requested gain to the tuner's supported list
    (`convenience.c:112-137`)."""
    gains = TUNER_GAINS.get(tuner.lower())
    if not gains:
        raise PlanError(f"unknown tuner {tuner!r}")
    best = gains[0]
    for g in gains:
        if abs(target_tenth_db - g) < abs(target_tenth_db - best):
            best = g
    return best


# --- Combined capture plan ---------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CapturePlan:
    """Everything the hardware will actually do for a tune request."""

    sample_rate: SampleRatePlan
    lo: PllPlan
    gain_tenth_db: int
    tuner: str

    @property
    def lo_error_hz(self) -> float:
        return self.lo.error_hz

    @property
    def rate_error_ppm(self) -> float:
        return self.sample_rate.rate_error_ppm


def plan_capture(
    freq_hz: float,
    samp_rate_hz: float,
    *,
    gain_tenth_db: int = 280,
    tuner: str = "r820t",
    xtal_hz: float = DEFAULT_RTL_XTAL_HZ,
    ppm: float = 0.0,
) -> CapturePlan:
    """Predict achieved LO / rate / gain for one dongle configuration.

    Feed `sample_rate.real_rate_hz` (not the request) into TDOA
    lag→meters conversion; compare `lo.actual_hz` across nodes for the
    coherent-correlation frequency-offset budget.
    """
    rate = plan_sample_rate(samp_rate_hz, xtal_hz=xtal_hz, ppm=ppm)
    t = tuner.lower()
    if t in ("r820t", "r828d"):
        lo = plan_r82xx_pll(freq_hz, xtal_hz=xtal_hz, ppm=ppm,
                            vco_power_ref=1 if t == "r828d" else 2)
    elif t == "e4000":
        lo = plan_e4k_pll(freq_hz, fosc_hz=xtal_hz, ppm=ppm)
    elif t == "fc0012":
        lo = plan_fc0012_pll(freq_hz, xtal_hz=xtal_hz, ppm=ppm)
    elif t == "fc0013":
        lo = plan_fc0013_pll(freq_hz, xtal_hz=xtal_hz, ppm=ppm)
    elif t == "fc2580":
        lo = plan_fc2580_pll(freq_hz, xtal_hz=xtal_hz, ppm=ppm)
    else:
        raise PlanError(f"unknown tuner {tuner!r}")
    return CapturePlan(
        sample_rate=rate, lo=lo,
        gain_tenth_db=nearest_gain(gain_tenth_db, t), tuner=t,
    )
