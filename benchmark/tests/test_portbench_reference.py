"""The plain reference: its own planning and rounding, its independence
from the program, and its agreement with the program's plain CPU path at
a tiny size."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch
from conftest import BENCH, SEED, tiny_cell

from harness import check, scene
from reference import tdoa


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")) + [BENCH / "harness" / "check.py",
                                                                                 BENCH / "harness" / "control.py"],
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & {"radio_mapper_tpu_torch", "radio_mapper_tpu", "jax", "jaxlib", "flax"}


def test_fft_lengths():
    assert tdoa.ct_nfft(16384 + 512) == 17408
    assert tdoa.ct_nfft(96000 + 512) == 97280
    assert tdoa.smooth_nfft(8 * 16384 + 512) == 135000
    assert tdoa.smooth_nfft(4 * 1024 + 128) == 4320


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 3.14159265, -2.5e-7])
    y = tdoa.tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-10 and y[2] == 1.0 + 2**-10
    assert ((y - x).abs() <= x.abs() * 2**-11).all()
    bits = y.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()


def test_decode_interleaved_bytes():
    raw = torch.tensor([[0, 255, 127, 128]], dtype=torch.uint8)
    assert torch.equal(tdoa.decode(raw), torch.tensor([[complex(-127.5, 127.5), complex(-0.5, 0.5)]], dtype=torch.complex64))


def test_lower_median_and_parabola():
    assert tdoa.lower_median(torch.tensor([[4.0, 1.0, 3.0, 2.0]])).item() == 2.0
    assert tdoa.lower_median(torch.tensor([[5.0, 1.0, 3.0]])).item() == 3.0
    m = torch.tensor([[0.0, 1.0, 2.0, 1.5, 0.0]])
    d = tdoa.parabola(m, torch.tensor([2]))
    assert d.item() == pytest.approx(0.5 * (1.0 - 1.5) / (1.0 - 4.0 + 1.5))


def test_lm_finds_a_noise_free_fix():
    anchors = torch.tensor([[0.0, 0.0, 0.0], [10e3, 0.0, 0.0], [0.0, 10e3, 0.0], [10e3, 10e3, 0.0]], dtype=torch.float64)
    x = torch.tensor([3e3, 6e3, 0.0], dtype=torch.float64)
    d = (x - anchors).norm(dim=-1)
    i, j = tdoa.pair_indices(4, "cpu")
    tau = ((d[i] - d[j]) / tdoa.SPEED_OF_LIGHT_M_S).unsqueeze(0)
    step = tdoa.Step(num_buoys=4, block_len=16384, sample_rate_hz=2.4e6, max_lag=512)
    fix = tdoa.solve(anchors, tau, torch.ones_like(tau), step)
    assert (fix[0, :2] - x[:2]).norm().item() < 1e-3


def test_reference_agrees_with_the_program_on_the_cpu(cell_name):
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline

    cell = tiny_cell(cell_name)
    p = cell.config["pipeline"]
    sc = scene.synthesize(p, cell.config["channels"], cell.traffic, SEED, "cpu")
    out = TDOAPipeline(PipelineConfig(**p), device="cpu").step_split_uint8(sc.pool[0], sc.anchors)
    numbers = check.compare(sc.pool[0], sc.anchors, out, tdoa.Step.from_config(p), cell.limits["limits"]["lag_pick"])
    ok, rows = check.verdict(numbers, cell.limits["limits"])
    assert ok, rows
    assert numbers["peak_pick_db"] == 0.0 and numbers["lag_pick"] < 1e-6
    assert np.isfinite(list(numbers.values())).all()
