"""Port parity: planning tables, constants, decode, simulator, inputs.

The tables are the port's "weights", computed with the same numpy code as
the JAX package — held bit-identical (no tolerance: same float64 numpy
arithmetic, same float32 cast). The simulator and the example inputs draw
from the same ``default_rng(seed)`` stream — also bit-identical.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from radio_mapper_tpu import constants as jconst
from radio_mapper_tpu import sim as jsim
from radio_mapper_tpu.models import pipeline as jpipe
from radio_mapper_tpu.ops import iq as jiq
from radio_mapper_tpu.ops import split_complex as jsc
from radio_mapper_tpu.ops.pallas import detect_kernel, fft_kernel, gcc_kernel

from radio_mapper_tpu_torch import constants, sim
from radio_mapper_tpu_torch.models import pipeline
from radio_mapper_tpu_torch.ops import ct_plan, iq


@pytest.mark.parametrize(
    "name",
    [
        "SPEED_OF_LIGHT_M_S", "WGS84_A", "WGS84_F", "WGS84_B", "WGS84_E2",
        "DEFAULT_SAMPLE_RATE_HZ", "DEFAULT_DETECTION_THRESHOLD_DBM",
        "DEFAULT_CONFIDENCE_FLOOR", "DEFAULT_SNR_FULLSCALE_DB",
        "DEFAULT_DC_NOTCH_HZ", "DEFAULT_PEAK_MIN_DISTANCE_BINS",
        "DEFAULT_BLOCK_SAMPLES",
    ],
)
def test_constants_equal(name):
    assert getattr(constants, name) == getattr(jconst, name)


def test_uint8_offset_equal():
    assert constants.UINT8_OFFSET == jiq.UINT8_OFFSET


@pytest.mark.parametrize("n", [1024, 2048, 5120, 9216, 16384, 17408, 24576, 33792])
def test_ct_split_and_permutation_equal(n):
    assert ct_plan.ct_split(n) == fft_kernel.ct_split(n)
    np.testing.assert_array_equal(ct_plan.ct_permutation(n), fft_kernel.ct_permutation(n))


def test_ct_split_rejects_like_reference():
    for n in (1000, 127 * 3):
        with pytest.raises(ValueError):
            fft_kernel.ct_split(n)
        with pytest.raises(ValueError):
            ct_plan.ct_split(n)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [5120, 9216, 17408])
def test_ct_constants_bit_identical(n, inverse):
    ours = ct_plan.ct_constants(n, inverse)
    ref = fft_kernel.ct_constants(n, inverse=inverse)
    assert ours[:2] == ref[:2]
    for a, b in zip(ours[2:], ref[2:]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("min_len", [1, 1024, 1025, 4096 + 128, 8192 + 256, 16384 + 512, 16384 + 600])
def test_plan_nfft_equal(min_len):
    assert ct_plan.plan_nfft(min_len) == gcc_kernel.plan_nfft(min_len)


@pytest.mark.parametrize("notch", [None, 0.0, 10_000.0, 2e6])
@pytest.mark.parametrize("nfft", [5120, 17408])
def test_notch_keep_range_equal(nfft, notch):
    assert ct_plan.notch_keep_range(nfft, 2.4e6, notch) == detect_kernel.notch_keep_range(
        nfft, 2.4e6, notch
    )


@pytest.mark.parametrize(
    "conf_floor,offset", [(0.3, 0.0), (0.3, 42.1), (0.0, 40.0), (1.5, 0.0)]
)
def test_detect_plan_equal(conf_floor, offset):
    kw = dict(
        sample_rate_hz=2.4e6, threshold_db=-70.0, min_distance_bins=10,
        dc_notch_hz=10_000.0, confidence_floor=conf_floor,
        snr_fullscale_db=20.0, power_offset_db=offset,
    )
    n1, n2, ref = detect_kernel._detect_plan(9216, **kw, bisect_iters=24, emit_topk=0)
    ours = ct_plan.detect_plan(9216, **kw)
    assert (ours.n1, ours.n2) == (n1, n2)
    assert ours.radius == ref["radius"]
    assert ours.thr_lin == ref["thr_lin"]
    assert (ours.keep_lo, ours.keep_hi) == (ref["keep_lo"], ref["keep_hi"])
    assert ours.conf_cs == ref["conf_cs"]
    assert ours.power_offset_db == ref["power_offset_db"]
    assert ours.bisect_iters == ref["bisect_iters"]


def test_decode_uint8_split_equal():
    raw = np.random.default_rng(4).integers(0, 256, size=(3, 2, 64), dtype=np.uint8)
    jr, ji = jsc.decode_uint8_split(raw)
    tr, ti = iq.decode_uint8_split(torch.from_numpy(raw))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize(
    "kw",
    [
        dict(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8, block_len=4096),
        dict(signal="bpsk", bandwidth_hz=50e3, snr_db=10.0, seed=3, block_len=2048,
             freq_offset_hz=40e3, timing_jitter_s=1e-7),
    ],
)
def test_sim_synthesize_bitwise(kw):
    ours = sim.synthesize(sim.default_scenario(**kw))
    ref = jsim.synthesize(jsim.default_scenario(**kw))
    for f in ("iq", "delays_s", "geometric_delays_s", "amplitudes", "buoy_enu", "emitter_enu"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)


@pytest.mark.parametrize("uint8", [False, True])
def test_example_inputs_equal(uint8):
    jcfg = jpipe.PipelineConfig(num_buoys=4, block_len=1024, max_lag=64)
    cfg = pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))
    ours = pipeline.TDOAPipeline(cfg, device="cpu").example_inputs(batch=(2,), seed=5, uint8=uint8)
    ref = jpipe.TDOAPipeline(jcfg).example_inputs(batch=(2,), seed=5, uint8=uint8, split=True)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_config_from_dict_and_unported_routes():
    jcfg = jpipe.PipelineConfig()
    assert dataclasses.asdict(pipeline.PipelineConfig.from_dict(dataclasses.asdict(jcfg))) == (
        dataclasses.asdict(jcfg)
    )
    for bad in (dict(correlation_dwells=2), dict(solver_starts=4), dict(weighting="cc")):
        with pytest.raises(NotImplementedError):
            pipeline.TDOAPipeline(pipeline.PipelineConfig(**bad), device="cpu")


def test_package_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import radio_mapper_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'radio_mapper_tpu' or k.startswith('radio_mapper_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
