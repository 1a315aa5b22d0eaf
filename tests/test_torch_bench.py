"""The port's throughput benchmark (``radio_mapper_tpu_torch/bench.py``) vs
the JAX package's root ``bench.py``, on the CPU at small sizes.

- the analytic FLOP count, the baseline and the JSON line's keys (read
  from the dict literal in the reference's ``main`` with ``ast``) equal
  the reference's;
- each leg's inputs equal the reference leg's draws for the same seed
  (the reference's epoch timer is replaced by one that records its
  arguments, so nothing is timed);
- one dispatch of the flagship leg's scan step equals the JAX
  ``jit_step_split_scan`` on the same inputs (the JAX side on the TPU
  routing, tolerances of ``tests/test_torch_pipeline.py``);
- every leg runs on ``device="cpu"`` at a tiny size and returns finite
  positive numbers; ``main``'s order, ladder and JSON line with its legs
  replaced by stand-ins;
- ``python -m radio_mapper_tpu_torch bench --help`` exits 0, and ``bench``
  on the default ``--device cuda`` without a card exits non-zero.
"""

import ast
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench as ref_bench

from radio_mapper_tpu_torch import bench, sim
from radio_mapper_tpu_torch.ingest.runner import IngestLoopStats
from radio_mapper_tpu_torch.models.wideband import WidebandConfig
from radio_mapper_tpu_torch.testing import cap_cpu_threads

from test_torch_pipeline import _assert_outputs_match, _jax_fused_run

cap_cpu_threads()

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(num_channels=2, num_buoys=4, block_len=2048, max_lag=64)


@pytest.mark.parametrize("shape", [
    (64, 8, 16_384, 512), (128, 8, 16_384, 512), (256, 8, 16_384, 512),
    (2, 4, 2048, 64), (16, 64, 4096, 256), (1, 2, 1000, 7),
])
def test_analytic_step_flops_matches_reference(shape):
    assert bench._analytic_step_flops(*shape) == ref_bench._analytic_step_flops(*shape)


def test_baseline_matches_reference():
    assert bench.BASELINE_SAMPLES_PER_S_PER_CHIP == ref_bench.BASELINE_SAMPLES_PER_S_PER_CHIP


def _reference_result_keys():
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = [n for n in ast.walk(main) if isinstance(n, ast.Dict) and any(
        isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys)]
    assert len(dicts) == 1
    return tuple(k.value for k in dicts[0].keys)


def test_result_keys_match_reference():
    assert bench.RESULT_KEYS == _reference_result_keys()
    assert "cuda" not in bench.PEAK_FLOPS_BY_DEVICE and 197e12 not in bench.PEAK_FLOPS_BY_DEVICE.values()


def _recorded_args(monkeypatch, module, run):
    """``run()`` with ``module._median_epoch_time`` recording its ``args``
    instead of timing them."""
    seen = []

    def record(step, args, **kw):
        seen.append(args)
        return 1.0

    monkeypatch.setattr(module, "_median_epoch_time", record)
    run()
    (args,) = seen
    return [np.asarray(a) for a in args]


@pytest.mark.parametrize("leg", ["flagship", "fft", "gcc", "ep"])
def test_leg_inputs_match_reference(leg, monkeypatch):
    if leg == "flagship":
        ref_name, _, ref_args, ref_flops = ref_bench.build_pipeline_step(scan_blocks=2, **SMALL)
        name, _, args, flops = bench.build_pipeline_step(scan_blocks=2, device="cpu", **SMALL)
        assert (name, flops) == (ref_name, ref_flops)
        ours, ref = [a.numpy() for a in args], [np.asarray(a) for a in ref_args]
    elif leg == "fft":
        kw = dict(rows=4, n=1024, iters=1)
        ref = _recorded_args(monkeypatch, ref_bench, lambda: ref_bench.run_fft_microbench(**kw))
        ours = _recorded_args(monkeypatch, bench, lambda: bench.run_fft_microbench(device="cpu", **kw))
    elif leg == "gcc":
        kw = dict(channels=2, num_buoys=4, n=1024, max_lag=32, iters=1, scan_blocks=2)
        ref = _recorded_args(monkeypatch, ref_bench, lambda: ref_bench.run_gcc_microbench(**kw))
        ours = _recorded_args(monkeypatch, bench, lambda: bench.run_gcc_microbench(device="cpu", **kw))
    else:  # the port's rank draws with _ep_inputs, then stacks the blocks as _stack does
        ref = _recorded_args(monkeypatch, ref_bench, lambda: ref_bench.run_ep_microbench(
            num_buoys=4, block_len=256, max_lag=16, iters=1, scan_blocks=2))
        re, im, anchors = (torch.from_numpy(a) for a in bench._ep_inputs(4, 256))
        ours = [bench._stack(re, 2).numpy(), bench._stack(im, 2).numpy(), anchors.numpy()]
    assert len(ours) == len(ref)
    for a, r in zip(ours, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        np.testing.assert_array_equal(a, r)


def test_stack_is_materialized():
    x = torch.arange(6.0).reshape(2, 3)
    s = bench._stack(x, 3)
    assert s.shape == (3, 2, 3) and s.is_contiguous() and s.stride(0) == 6
    s[0, 0, 0] = -1.0
    assert s[1, 0, 0] == 0.0 and x[0, 0] == 0.0


def _scene_blocks():
    """Two blocks × two channels of simulated OKC scenes (one emitter each,
    seeds 0-3) at the leg's rate and length, as float32 planes, and the
    network's anchors per channel."""
    caps = [sim.synthesize(sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=s,
                                                block_len=SMALL["block_len"], sample_rate_hz=2.4e6))
            for s in range(4)]
    iq = np.stack([c.iq for c in caps]).reshape(2, 2, SMALL["num_buoys"], SMALL["block_len"])
    anchors = np.broadcast_to(caps[0].buoy_enu, (2, SMALL["num_buoys"], 3)).astype(np.float32)
    return caps, iq.real.astype(np.float32), iq.imag.astype(np.float32), anchors


@pytest.mark.parametrize("inputs", ["leg", "scenes"])
def test_flagship_scan_dispatch_matches_jax(inputs):
    """One dispatch of the flagship leg's scan step, port vs JAX, block by
    block. On the leg's own random draws the lags, peaks, floors and
    weights are held; the fix is not: random lags leave the LM hundreds of
    km out, where float32 rounding in 25 iterations moves it by metres
    (seen: 158 m at 675 km, 0.05 m on the other channel). On simulated
    scenes everything is held, the fix within 0.5 m and 50 m of the
    emitter."""
    _, ref_step, ref_args, _ = ref_bench.build_pipeline_step(scan_blocks=2, **SMALL)
    _, step, args, _ = bench.build_pipeline_step(scan_blocks=2, device="cpu", **SMALL)
    if inputs == "scenes":
        caps, re, im, anchors = _scene_blocks()
        ref_args = (jnp.asarray(re), jnp.asarray(im), jnp.asarray(anchors))
        args = (torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(anchors))
    ref = _jax_fused_run(lambda: ref_step(*ref_args))
    ours = step(*args)
    assert ours.fix.position_enu.shape == (2, SMALL["num_channels"], 3)
    for t in range(2):
        pick = lambda tree: type(tree)(*(pick(f) for f in tree)) if isinstance(tree, tuple) else tree[t]
        o, r = pick(ours), pick(ref)
        if inputs == "scenes":
            _assert_outputs_match(o, r)
            for c in range(2):
                err = np.linalg.norm(o.fix.position_enu[c, :2].numpy() - caps[2 * t + c].emitter_enu[0][:2])
                assert err < 50.0, err
        else:
            np.testing.assert_allclose(o.correlation.lag_samples.numpy(), np.asarray(r.correlation.lag_samples),
                                       atol=1e-3)
            np.testing.assert_array_equal(o.peaks.valid.numpy(), np.asarray(r.peaks.valid))
            np.testing.assert_array_equal(o.peaks.bin_index.numpy(), np.asarray(r.peaks.bin_index))
            np.testing.assert_allclose(o.peaks.noise_floor_db.numpy(), np.asarray(r.peaks.noise_floor_db),
                                       atol=1e-3)
            np.testing.assert_allclose(o.pair_weights.numpy(), np.asarray(r.pair_weights), atol=1e-3)
            assert np.isfinite(o.fix.position_enu.numpy()).all()


def _finite_positive(*xs):
    return all(math.isfinite(x) and x > 0 for x in xs)


_WB = WidebandConfig(num_buoys=8, wide_rate_hz=4_096_000.0, num_subchannels=8, sub_block=1024, max_lag=64,
                     solver_iterations=20)
_INGEST = dict(channels=1, num_buoys=4, block_len=2048, max_lag=64, steps=2, device="cpu")


@pytest.mark.parametrize("leg", [
    "flagship-scan", "flagship-complex", "fft", "gcc-scan", "gcc", "ep", "wideband", "ingest", "ingest-scan",
    "loopback",
])
def test_leg_runs_on_cpu(leg):
    if leg == "flagship-scan":
        rate, name, block_s, flops = bench.run_pipeline_bench(iters=1, scan_blocks=2, device="cpu", **SMALL)
        assert name == "split-scan2" and _finite_positive(rate, block_s, flops)
    elif leg == "flagship-complex":
        rate, name, block_s, flops = bench.run_pipeline_bench(iters=1, path="complex", device="cpu", **SMALL)
        assert name == "complex" and _finite_positive(rate, block_s, flops)
    elif leg == "fft":
        assert _finite_positive(bench.run_fft_microbench(rows=4, n=1024, iters=1, epochs=1, device="cpu"))
    elif leg.startswith("gcc"):
        scan = 2 if leg == "gcc-scan" else 1
        assert _finite_positive(bench.run_gcc_microbench(channels=2, num_buoys=4, n=1024, max_lag=32, iters=1,
                                                         scan_blocks=scan, epochs=1, device="cpu"))
    elif leg == "ep":
        launches = {}
        rate = bench.run_ep_microbench(num_buoys=4, block_len=512, max_lag=16, iters=1, scan_blocks=2,
                                       epochs=1, device="cpu", launches=launches)
        assert _finite_positive(rate) and launches == {}  # the CPU rank runs the plain route, no kernel
    elif leg == "wideband":
        assert _finite_positive(*bench.run_wideband_bench(iters=1, scan_blocks=2, device="cpu", config=_WB))
    elif leg.startswith("ingest"):
        bpd, over = (2, 1.3) if leg == "ingest-scan" else (1, 1.0)
        st = bench.run_ingest_bench(blocks_per_dispatch=bpd, overdrive=over, **_INGEST)
        assert st.steps == 2 and st.bytes_consumed == 2 * bpd * 4 * 2 * 2048
        assert _finite_positive(st.sustained_samples_per_s, st.real_time_ratio)
    else:
        st = bench.run_ingest_loopback_bench(channels=1, num_buoys=4, block_len=2048, steps=4, device="cpu")
        assert st.bytes_consumed == 4 * 4 * 2 * 2048 and _finite_positive(st.sustained_samples_per_s)


def _stats(ratio, dropped=0):
    return IngestLoopStats(steps=1, samples_per_step=1, elapsed_s=1.0, sustained_samples_per_s=2e6,
                           host_read_ms_per_step=1.0, transfer_ms_per_step=0.5, real_time_ratio=ratio,
                           dropped_bytes=dropped, bytes_consumed=2)


def test_main_order_ladder_and_line(monkeypatch, capsys):
    """``main`` with stand-in legs: the legs run in the reference's order,
    the sweep keeps the fastest config, the ingest ladder stops at the
    first rung that keeps up, and the line has the reference's keys."""
    calls = []
    ms_block = {64: 0.004, 128: 0.002, 256: 0.010}

    def build(*, num_channels, scan_blocks, device):
        calls.append(("sweep", num_channels, scan_blocks))
        return f"split-scan{scan_blocks}", None, (num_channels, scan_blocks), 1e9

    def epoch_time(step, args, *, iters, device, warmup):
        return ms_block[args[0]] * args[1]

    def ingest(*, channels, steps, device, blocks_per_dispatch=1, overdrive=1.0):
        calls.append(("ingest", channels, blocks_per_dispatch))
        return _stats(1.0 if channels == 8 else 0.5)

    monkeypatch.setattr(bench, "run_ingest_loopback_bench", lambda **kw: calls.append(("loopback",)) or _stats(3.0))
    monkeypatch.setattr(bench, "build_pipeline_step", build)
    monkeypatch.setattr(bench, "_epoch_time", epoch_time)
    monkeypatch.setattr(bench, "run_fft_microbench", lambda **kw: calls.append(("fft",)) or 1e9)
    monkeypatch.setattr(bench, "run_gcc_microbench", lambda **kw: calls.append(("gcc",)) or 1e6)
    monkeypatch.setattr(bench, "run_ep_microbench", lambda **kw: calls.append(("ep",)) or 2e6)
    monkeypatch.setattr(bench, "run_wideband_bench", lambda **kw: calls.append(("wideband",)) or (20.0, 5e7, 1.6e6))
    monkeypatch.setattr(bench, "run_ingest_bench", ingest)
    monkeypatch.delenv("BENCH_SCAN_BLOCKS", raising=False)
    monkeypatch.delenv("BENCH_GCC_FUSED", raising=False)
    bench.main(device="cpu")
    assert calls == [
        ("loopback",), ("sweep", 64, 64), ("sweep", 128, 64), ("sweep", 256, 16), ("fft",), ("gcc",), ("ep",),
        ("wideband",), ("ingest", 32, 1), ("ingest", 8, 1),
    ]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tuple(out) == bench.RESULT_KEYS
    assert out["backend"] == "cpu" and out["mfu"] is None and out["path"] == "split-scan64"
    assert out["step_ms"] == 2.0 and out["value"] == round(128 * 8 * 16_384 / 0.002, 1)
    assert out["ingest_channels"] == 8 and out["ingest_blocks_per_dispatch"] == 1
    assert out["wideband_ms_per_block"] == 20.0 and out["ep_pairs_per_s"] == 2e6


def test_cli_bench_help_exits_zero():
    r = subprocess.run([sys.executable, "-m", "radio_mapper_tpu_torch", "bench", "--help"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "usage" in r.stdout


@pytest.mark.parametrize("argv", [["radio_mapper_tpu_torch", "bench"], ["radio_mapper_tpu_torch.bench"]])
def test_bench_without_a_card_exits_nonzero(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test holds the no-card path")
    r = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert r.stdout.strip() == ""
