"""The check must fail the control and the faults a cell can have.

The control is the plain reference computed one precision below the
configuration's (TF32 for float32) put in the program's place; on the
card it is read at the cells' own sizes by ``tools/calibrate.py`` (the
readings and limits are in PERF.md). The faults are planted under a
whole run with the harness's look for a card skipped: half of the batch
left out (the rest's answers in its place), an answer altered where it
is produced (a peak bin, a lag, a fix), and a step that returns its last
answers unchanged.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch
from conftest import SEED, tiny_cell

from harness import driver
from harness.control import ReferenceProgram
from reference import tdoa


def _run(cell, program):
    result, rows = driver.run(cell, SEED, 0.3, False, t0=time.perf_counter(), device="cpu",
                              program=program, require_chip=False, log=lambda _m: None)
    return result, {name: (v, lim) for name, v, lim in rows}


def _program(cell):
    return driver.build_program(cell, torch.device("cpu"))


def _clone(out):
    """A mutable copy of an output's fields the check reads."""
    return SimpleNamespace(
        peaks=SimpleNamespace(**{k: getattr(out.peaks, k).clone() for k in
                                 ("bin_index", "valid", "power_db", "noise_floor_db")}),
        correlation=SimpleNamespace(**{k: getattr(out.correlation, k).clone() for k in ("lag_samples", "psr")}),
        fix=SimpleNamespace(position_enu=out.fix.position_enu.clone()),
    )


class Faulty:
    """The program with ``fault`` applied to every output it returns."""

    def __init__(self, program, fault):
        self.program, self.fault, self.last = program, fault, None

    def step_split_uint8(self, raw, anchors, *, on_stage=None):
        out = _clone(self.program.step_split_uint8(raw, anchors, on_stage=on_stage))
        new = self.fault(self, raw, out)
        self.last = out
        return new


def half_batch(self, raw, out):
    """The first half of the channels computed, the second half's answers
    copied from it (the rest standing in for what was left out)."""
    def fill(t):
        flat = t.reshape(-1, *t.shape[raw.dim() - 2:])
        h = flat.shape[0] // 2
        flat[h: 2 * h] = flat[:h]
        return t
    for group in (out.peaks, out.correlation, out.fix):
        for k, v in vars(group).items():
            setattr(group, k, fill(v))
    return out


def altered_bin(self, raw, out):
    out.peaks.bin_index.view(-1)[0] += 40
    return out


def altered_lag(self, raw, out):
    out.correlation.lag_samples.view(-1)[3] += 3.0
    return out


def altered_fix(self, raw, out):
    out.fix.position_enu.view(-1)[0] += 200.0
    return out


def stale(self, raw, out):
    """The step returns its previous answers unchanged."""
    return self.last if self.last is not None else out


FAULTS = [half_batch, altered_bin, altered_lag, altered_fix, stale]


def test_the_program_passes(cell_name):
    cell = tiny_cell(cell_name)
    result, _ = _run(cell, _program(cell))
    assert result["correct"]


def test_the_tf32_control_fails(cell_name):
    cell = tiny_cell(cell_name)
    control = ReferenceProgram(tdoa.Step.from_config(cell.config["pipeline"]), tf32=True)
    result, rows = _run(cell, control)
    assert not result["correct"], rows
    over = [n for n, (v, lim) in rows.items() if not v <= lim]
    assert over


def test_the_float32_reference_in_the_programs_place_passes(cell_name):
    cell = tiny_cell(cell_name)
    result, rows = _run(cell, ReferenceProgram(tdoa.Step.from_config(cell.config["pipeline"]), tf32=False))
    assert result["correct"], rows


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_planted_fault_fails(cell_name, fault):
    cell = tiny_cell(cell_name)
    result, rows = _run(cell, Faulty(_program(cell), fault))
    assert not result["correct"], rows
    assert result["failed"] >= 1
