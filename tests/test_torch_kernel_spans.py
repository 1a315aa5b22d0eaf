"""The program spans of kernels K1 and K2 alone (``fft_detect.k1``,
``gcc_pair.k2``) and the benchmark's reader of their roofline shares.

On the CPU: each span opens around its kernel's counted launch (the
launch itself stubbed, as a CUDA kernel has no CPU mode), once a call,
only inside a traced step; ``benchmark/readers/span_roofline.py`` on
synthetic step records. On the card (marked ``cuda``, skipped without
one): a traced flagship step at block_len 96000, the wide designs.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_spans.py
"""

import importlib
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_detect, gcc_pair, lm_solve
from radio_mapper_tpu_torch.utils import spans

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
K1_DESIGNS = ("block", "cluster", "wide", "long")


def _names(rec):
    return [s.name for s in rec.spans]


@pytest.fixture
def stub_k1(monkeypatch):
    """Every K1 design replaced by a stub that records its call."""
    calls = []

    def stub(design):
        def run(re, im, plan, emit_topk=0):
            calls.append(design)
            return (re, im)
        return run

    for d in ("block", "cluster", "wide"):
        monkeypatch.setattr(fft_detect, f"{d}_detect", stub(d))
    monkeypatch.setattr(fft_detect.fft_rows, "long_rows", lambda re, im: (re, im))
    monkeypatch.setattr(fft_detect.detect_ct, "launch", lambda *a, **k: (calls.append("long"), 0.0))
    return calls


@pytest.mark.parametrize("design", K1_DESIGNS)
def test_k1_span_wraps_each_design_once_in_a_traced_step(stub_k1, design):
    x = torch.zeros(2, 8)
    before = dict(fft_detect.design_counts)
    with spans._Step(torch.device("cpu")):
        fft_detect._run(design, x, x, None, 0)
    rec = spans.steps()[-1]
    assert _names(rec) == ["step", "fft_detect.k1"] and rec.spans[1].parent == 0
    assert stub_k1 == [design] and fft_detect.design_counts[design] == before[design] + 1
    assert rec.host_ms("fft_detect.k1") >= 0 and rec.device_ms("fft_detect.k1") is None  # no events off the card


def test_k2_span_wraps_the_counted_launch_only(monkeypatch):
    calls = []
    monkeypatch.setattr(gcc_pair, "launch_k2", lambda *a: calls.append(a) or "windows")
    before = gcc_pair.launch_count
    with spans._Step(torch.device("cpu")):
        assert gcc_pair._launch(None, None, None, [0], [1], 4, 0.05, "l2rx") == "windows"
        gcc_pair.launch_k2(None, None, None, [0], [1], 4, 0.05, "l2rx")  # kernel K8's call: no span
    rec = spans.steps()[-1]
    assert _names(rec) == ["step", "gcc_pair.k2"]
    assert len(calls) == 2 and gcc_pair.launch_count == before + 1


def test_kernel_spans_record_nothing_without_a_hook(stub_k1, monkeypatch):
    monkeypatch.setattr(gcc_pair, "launch_k2", lambda *a: "windows")
    n = len(spans.steps())
    x = torch.zeros(2, 8)
    fft_detect._run("wide", x, x, None, 0)
    gcc_pair._launch(None, None, None, [0], [1], 4, 0.05, "l2rx")
    assert len(spans.steps()) == n and stub_k1 == ["wide"]
    assert spans.span("fft_detect.k1") is spans.span("gcc_pair.k2")  # the shared no-op


# ---- the benchmark's reader: 100 × least ms of the work ÷ the span's median device ms


@pytest.fixture
def bench(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))
    return importlib.import_module("harness.manifest")


def _run(manifest, cell, dispatches, profiled):
    return SimpleNamespace(cell=manifest.load_cell(cell), dispatches=dispatches, profiled_dispatches=profiled,
                           lead=(16, 128) if cell == "flagship.long96k" else (128, 128))


def _store(monkeypatch, values, span):
    recs = [SimpleNamespace(device_ms=lambda name, v=v: v if name == span else None) for v in values]
    monkeypatch.setattr(spans, "steps", lambda: list(recs))


@pytest.mark.parametrize("cell,span,work", [
    ("flagship.long96k", "fft_detect.k1", "fft_detect"),
    ("flagship.long96k", "gcc_pair.k2", "gcc_pair"),
    ("flagship.b128", "fft_detect.k1", "fft_detect"),
    ("flagship.b128", "gcc_pair.k2", "gcc_pair"),
])
def test_span_roofline_is_the_least_over_the_window_median(bench, monkeypatch, cell, span, work):
    # a warm step, a window of three, one profiled after it
    _store(monkeypatch, [1.0, 40.0, 50.0, 45.0, 1.0], span)
    run = _run(bench, cell, 3, 1)
    reader = bench.reader("span_roofline")
    flops, nbytes = bench.work(work).least(run.cell.config["pipeline"], run.lead)
    least_ms = 1e3 * max(flops / 495e12, nbytes / 3.35e12)
    assert reader.read(run, span=span, work=work) == pytest.approx(100.0 * least_ms / 45.0)


def test_span_roofline_at_long96k_counts_the_wide_rows(bench):
    """The least K1 work a long96k dispatch needs: 16384 rows of 96000
    samples through nfft 97280, bytes-bound at ~8.04 ms."""
    run = _run(bench, "flagship.long96k", 1, 0)
    flops, nbytes = bench.work("fft_detect").least(run.cell.config["pipeline"], run.lead)
    rows, nfft = 16 * 128 * 8, 97_280
    assert nbytes == rows * (8 * 96_000 + 8 * nfft + 8 * (nfft // 8) + 8)
    assert flops == pytest.approx(rows * (5 * nfft * math.log2(nfft) + 6 * nfft))
    assert 1e3 * nbytes / 3.35e12 == pytest.approx(8.04, abs=0.01) and flops / 495e12 < nbytes / 3.35e12


def test_span_roofline_finds_nothing_where_the_span_is_absent(bench, monkeypatch):
    _store(monkeypatch, [40.0, 50.0], "solve.lm.kernel")
    run = _run(bench, "flagship.long96k", 2, 0)
    assert bench.reader("span_roofline").read(run, span="fft_detect.k1", work="fft_detect") is None
    monkeypatch.setattr(spans, "steps", lambda: [])
    assert bench.reader("span_roofline").read(run, span="gcc_pair.k2", work="gcc_pair") is None


def test_span_roofline_finds_nothing_without_the_recorder(bench, monkeypatch):
    import radio_mapper_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "radio_mapper_tpu_torch.utils.spans", None)  # the import fails
    monkeypatch.delattr(utils, "spans", raising=False)
    run = _run(bench, "flagship.b128", 3, 0)
    assert bench.reader("span_roofline").read(run, span="fft_detect.k1", work="fft_detect") is None


# ---- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_traced_long_block_step_records_k1_and_k2_once(cuda_device):
    """block_len 96000 (nfft 97280 = 640·152), 2 blocks of 4 channels: a
    traced step runs K1's wide design, K2 and the LM kernel once each and
    records ``fft_detect.k1`` and ``gcc_pair.k2`` once, with device time
    inside the step's; an untraced step records nothing."""
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline

    cfg = PipelineConfig(num_buoys=8, block_len=96_000, sample_rate_hz=2.4e6, max_lag=512, max_peaks=8,
                         solver_iterations=40)
    assert cfg.nfft == 97_280 and ct_plan.ct_split(cfg.nfft) == (640, 152)
    pipe = TDOAPipeline(cfg, device=cuda_device)
    raw, anchors = pipe.example_inputs(batch=(2, 4), seed=3, uint8=True)
    pipe.step_split_uint8(raw, anchors)  # builds and warms
    torch.cuda.synchronize()
    n = len(spans.steps())
    pipe.step_split_uint8(raw, anchors)
    torch.cuda.synchronize()
    assert len(spans.steps()) == n
    counts = (fft_detect.design_counts["wide"], gcc_pair.launch_count, lm_solve.launch_count)
    out = pipe.step_split_uint8(raw, anchors, on_stage=lambda _name: None)
    torch.cuda.synchronize()
    assert np.isfinite(out.fix.position_enu.cpu().numpy()).all()
    got = (fft_detect.design_counts["wide"], gcc_pair.launch_count, lm_solve.launch_count)
    assert tuple(b - a for a, b in zip(counts, got)) == (1, 1, 1)
    rec = spans.steps()[-1]
    names = _names(rec)
    assert names.count("fft_detect.k1") == 1 and names.count("gcc_pair.k2") == 1
    k1, k2, step = rec.device_ms("fft_detect.k1"), rec.device_ms("gcc_pair.k2"), rec.device_ms("step")
    assert 0 < k1 and 0 < k2 and k1 + k2 < step
