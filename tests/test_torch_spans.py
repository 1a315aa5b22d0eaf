"""The step's program spans (``radio_mapper_tpu_torch.utils.spans``) on the
CPU: nesting, sequence numbers, host intervals, the store's bound, the
sync counter, the spans and the hook's marks on every route, and that a
step with no hook records nothing and a step with one computes the same."""

from __future__ import annotations

import contextlib
import warnings

import pytest
import torch

from radio_mapper_tpu_torch.models import pipeline
from radio_mapper_tpu_torch.ops import detect
from radio_mapper_tpu_torch.ops import split_complex as sc
from radio_mapper_tpu_torch.ops.cuda import channel_step
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from radio_mapper_tpu_torch.utils import spans

cap_cpu_threads()

SYNC = "called a synchronizing CUDA operation"
SOLVER_SPANS = ["step", "solve.prep", "solve.lm"]

# name → (config, entry)
STEPS = {
    "flagship": (dict(num_buoys=3, block_len=2048, max_lag=64, solver_iterations=3), "step_split_uint8"),
    "narrowband": (dict(num_buoys=3, block_len=1024, max_lag=64, solver_iterations=3, correlation_dwells=4,
                        solver_starts=4), "step_split_uint8"),
    "complex": (dict(num_buoys=3, block_len=1024, max_lag=64, solver_iterations=3, correlation_dwells=2),
                "step_uint8"),
}


def _traced(name, **kw):
    cfg, entry = STEPS[name]
    pipe = pipeline.TDOAPipeline(pipeline.PipelineConfig(**{**cfg, **kw}), device="cpu")
    raw, anchors = pipe.example_inputs(batch=(2,), seed=3, uint8=True)
    seen = []
    n0 = spans.steps()[-1].seq if spans.steps() else -1
    out = getattr(pipe, entry)(raw, anchors, on_stage=seen.append)
    rec = spans.steps()[-1]
    assert rec.seq > n0
    return pipe, (raw, anchors), out, seen, rec


def _by_name(rec):
    return {s.name: s for s in rec.spans}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_solver_spans_nest_under_step(name):
    _, _, _, _, rec = _traced(name)
    root = rec.spans[0]
    assert root.name == "step" and root.parent == -1
    assert [s.name for s in rec.spans] == SOLVER_SPANS
    assert [s.parent for s in rec.spans] == [-1, 0, 0]


@pytest.mark.parametrize("name", sorted(STEPS))
def test_spans_share_the_step_and_lie_inside_their_parents(name):
    _, _, _, _, rec = _traced(name)
    assert {s.seq for s in rec.spans} == {rec.seq}
    for s in rec.spans[1:]:
        p = rec.spans[s.parent]
        assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    for s in rec.spans:
        assert rec.self_host_ms(s.name) >= 0.0
    prep, lm = rec.spans[1:]
    assert prep.t1_ns <= lm.t0_ns
    assert rec.self_host_ms("step") == pytest.approx(rec.host_ms("step") - prep.host_ms - lm.host_ms)
    assert rec.device_ms("solve.lm") is None  # no card
    assert rec.syncs("step") == 0  # nothing counts syncs off the card


@pytest.mark.parametrize("name", sorted(STEPS))
def test_outputs_are_bit_identical_with_and_without_a_hook(name):
    pipe, args, traced, _, _ = _traced(name)
    plain = getattr(pipe, STEPS[name][1])(*args)
    for a, b in zip(torch.utils._pytree.tree_leaves(traced), torch.utils._pytree.tree_leaves(plain)):
        assert torch.equal(a, b)


def test_no_hook_records_nothing_and_enters_no_range(monkeypatch):
    cfg, entry = STEPS["narrowband"]
    pipe = pipeline.TDOAPipeline(pipeline.PipelineConfig(**cfg), device="cpu")
    raw, anchors = pipe.example_inputs(batch=(2,), seed=3, uint8=True)
    before = spans.steps()
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: entered.append(a))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: entered.append(a))
    monkeypatch.setattr(spans, "_Step", lambda *a, **k: entered.append(a))
    getattr(pipe, entry)(raw, anchors)
    assert entered == []
    assert [r.seq for r in spans.steps()] == [r.seq for r in before]
    assert spans.span("solve.lm") is spans.span("solve.prep")  # the shared no-op


def test_nested_entries_make_one_step():
    """``step_split_uint8`` calls ``step_split``, which joins its record."""
    n = len(spans.steps())
    _, _, _, seen, rec = _traced("flagship")
    assert len(spans.steps()) == min(n + 1, spans.STORE_STEPS)
    assert [s.name for s in rec.spans].count("step") == 1
    assert seen[0] == "decode"


# route → (config changes, knob setters with (mode, default))
ROUTES = {
    "default": ({}, []),
    "mega": ({}, [(channel_step.set_mega_fused, "on", "off")]),
    "two-kernel": ({}, [(detect.set_fused_fft_detect, "off", "auto")]),
    "unfused-detect": ({}, [(detect.set_fused_detect, "off", "auto")]),
    "unfused-gcc": ({}, [(sc.set_gcc_fused, "off", "auto")]),
}


@pytest.mark.parametrize("route", sorted(ROUTES) + ["narrowband", "complex"])
def test_every_route_records_the_solver_spans_and_passes_each_mark_on(route, monkeypatch):
    """On every route the step records ``step``, ``solve.prep`` and
    ``solve.lm``, each in a profiler range ``rm.<name>``, and the caller's
    hook sees the marks it sees with the recorder off, in the same order."""
    names = []
    real = torch.profiler.record_function

    def spy(name, *args):
        names.append(name)
        return real(name, *args)

    changes, knobs = ROUTES.get(route, ({}, []))
    name = "flagship" if route in ROUTES else route
    try:
        for setter, mode, _ in knobs:
            setter(mode)
        pipe, args, _, _, _ = _traced(name, **changes)
        untraced = []
        monkeypatch.setattr(spans, "_Step", lambda _device: contextlib.nullcontext())  # the recorder off
        getattr(pipe, STEPS[name][1])(*args, on_stage=untraced.append)
        monkeypatch.undo()
        monkeypatch.setattr(torch.profiler, "record_function", spy)
        _, _, _, seen, rec = _traced(name, **changes)
    finally:
        for setter, _, default in knobs:
            setter(default)
    assert names == ["rm." + s for s in SOLVER_SPANS]
    assert [s.name for s in rec.spans] == SOLVER_SPANS
    assert seen == untraced and seen


class _Toy:
    """An entry of the step with no pipeline behind it."""

    device = torch.device("cpu")

    @spans.entry
    def run(self, x, *, on_stage=None, inner_warning=None, raise_in=None):
        with spans.span("outer"):
            with spans.span("inner"):
                if inner_warning:
                    warnings.warn(inner_warning)
                if raise_in == "inner":
                    raise RuntimeError("inner")
            warnings.warn(SYNC)
        on_stage("work")
        return x + 1


def test_store_stays_at_its_bound():
    toy = _Toy()
    for i in range(spans.STORE_STEPS + 7):
        toy.run(i, on_stage=lambda _name: None)
    recs = spans.steps()
    assert len(recs) == spans.STORE_STEPS
    seqs = [r.seq for r in recs]
    assert seqs == sorted(seqs) and seqs[-1] - seqs[0] == spans.STORE_STEPS - 1


def test_sync_warnings_are_charged_to_the_innermost_open_span():
    toy = _Toy()
    with warnings.catch_warnings(record=True) as passed:
        warnings.simplefilter("always")
        show, filters = warnings.showwarning, list(warnings.filters)
        assert toy.run(1, on_stage=lambda _name: None, inner_warning=SYNC) == 2
        rec = spans.steps()[-1]
        toy.run(1, on_stage=lambda _name: None, inner_warning="something else")
        assert warnings.showwarning is show and warnings.filters == filters
    by = _by_name(rec)
    assert by["inner"].syncs == 1 and by["outer"].syncs == 1
    assert rec.syncs("inner") == 1 and rec.syncs("outer") == 2 and rec.syncs("step") == 2
    assert by["step"].syncs == 0 and rec.syncs("absent") is None
    assert spans.steps()[-1].syncs("step") == 1
    # the other warning passed on; no synchronising one did
    assert [str(w.message) for w in passed] == ["something else"]


def test_a_step_that_raises_is_not_kept_and_leaves_nothing_open():
    toy = _Toy()
    n = spans.steps()[-1].seq if spans.steps() else -1
    show = warnings.showwarning
    with pytest.raises(RuntimeError):
        toy.run(1, on_stage=lambda _name: None, raise_in="inner")
    assert (spans.steps()[-1].seq if spans.steps() else -1) == n
    assert spans.span("x") is spans.span("y")  # no step open
    assert warnings.showwarning is show
    toy.run(1, on_stage=lambda _name: None)
    assert spans.steps()[-1].seq > n
