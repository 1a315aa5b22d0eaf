"""The per-layer metrics read from the program's own spans
(``readers/program_spans.py``): a traced tiny run of each cell on the CPU
reports the host figures and the sync count and no device figure; the
reader keeps the window's steps only, and finds nothing in a program
without the span recorder."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

from conftest import SEED, tiny_cell

from harness import driver, manifest

HOST = {"host_ms.solve_prep", "host_ms.solve_lm", "host_syncs"}
DEVICE = {"device_ms.solve_lm"}


def test_traced_run_reports_the_program_spans(cell_name):
    cell = tiny_cell(cell_name)
    assert HOST | DEVICE <= {m["name"] for m in cell.per_layer}
    result, _ = driver.run(cell, SEED, 0.5, True, t0=time.perf_counter(), device="cpu",
                           require_chip=False, log=lambda _m: None)
    metrics = result["metrics"]
    assert HOST <= set(metrics) and not DEVICE & set(metrics)
    assert metrics["host_ms.solve_prep"]["value"] > 0 and metrics["host_ms.solve_lm"]["value"] > 0
    assert metrics["host_syncs"] == {"value": 0.0, "unit": "count"}  # nothing synchronises off the card
    assert metrics["host_ms.solve_lm"]["unit"] == "ms"


def _store(monkeypatch, values):
    """A stand-in span store whose steps read ``values`` in order."""
    recs = [SimpleNamespace(host_ms=lambda _span, v=v: v) for v in values]
    fake = SimpleNamespace(steps=lambda: list(recs))
    monkeypatch.setitem(sys.modules, "radio_mapper_tpu_torch.utils.spans", fake)
    import radio_mapper_tpu_torch.utils as utils

    monkeypatch.setattr(utils, "spans", fake, raising=False)


def test_reader_keeps_the_window_steps_only(monkeypatch):
    reader = manifest.reader("program_spans")
    # two warm steps, a window of three, two profiled after it
    _store(monkeypatch, [100.0, 100.0, 1.0, 2.0, 9.0, 50.0, 50.0])
    run = SimpleNamespace(dispatches=3, profiled_dispatches=2)
    assert reader.read(run, span="solve.prep", value="host_ms") == 2.0
    run = SimpleNamespace(dispatches=2, profiled_dispatches=0)
    assert reader.read(run, span="solve.prep", value="host_ms") == 50.0


def test_reader_finds_nothing_without_the_recorder(monkeypatch):
    import radio_mapper_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "radio_mapper_tpu_torch.utils.spans", None)  # import fails
    monkeypatch.delattr(utils, "spans", raising=False)
    reader = manifest.reader("program_spans")
    run = SimpleNamespace(dispatches=3, profiled_dispatches=0)
    assert reader.read(run, span="solve.lm", value="host_ms") is None
