"""The long-block flagship (``flagship.long96k``): its configuration differs
from the flagship's only in its block length and what names it, its
traffic only in its dispatch depth, its length plans the wide designs,
and the program agrees with the plain reference at the published block
length on the CPU under the cell's own limits."""

from __future__ import annotations

import json

import numpy as np
from conftest import BENCH, SEED

from harness import check, manifest, scene
from reference import tdoa

CELL = "flagship.long96k"
N = 96_000
NFFT = 97_280  # ct_nfft(96000 + 512): 95 · 1024 = 640 · 152


def _json(path):
    return json.loads(path.read_text())


def test_config_is_the_flagships_with_long_blocks():
    flag = _json(BENCH / "configs" / "flagship.json")
    long = _json(BENCH / "configs" / "flagship_long96k.json")
    named = {"name", "source", "deployment", "route", "assumed", "pipeline"}
    assert set(flag) == set(long)
    assert {k: v for k, v in flag.items() if k not in named} == {k: v for k, v in long.items() if k not in named}
    assert {**flag["pipeline"], "block_len": N} == long["pipeline"]
    assert long["reduced"] == [] and set(flag["assumed"]) | {"block_len"} == set(long["assumed"])


def test_traffic_is_b128s_at_sixteen_blocks():
    b128 = _json(BENCH / "traffic" / "b128.json")
    long = _json(BENCH / "traffic" / "long96k.json")
    assert {k: v for k, v in b128.items() if k not in ("who", "blocks_per_dispatch")} == \
        {k: v for k, v in long.items() if k not in ("who", "blocks_per_dispatch")}
    assert long["emitter"] == b128["emitter"] and long["network"] == b128["network"]
    assert (long["blocks_per_dispatch"], long["pool"], long["check_dispatches"]) == (16, 2, 1)


def test_the_length_plans_the_wide_designs():
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig
    from radio_mapper_tpu_torch.ops import ct_plan
    from radio_mapper_tpu_torch.ops.cuda import fft_detect, gcc_pair

    cell = manifest.load_cell(CELL)
    cfg = PipelineConfig(**cell.config["pipeline"])
    assert cfg.nfft == tdoa.ct_nfft(N + 512) == NFFT
    assert ct_plan.ct_split(NFFT) == (640, 152)
    assert fft_detect.geometry(NFFT) == "wide"  # K1 in one launch of the wide design
    assert gcc_pair._geometry(NFFT, cfg.max_lag, "K2")[0] == 640  # K2's wide pair body


def test_program_agrees_with_the_reference_at_the_published_length():
    """Two channels and one block of 96000 samples, the cell's network and
    emitters; every number within the cell's limits, the peak picks
    exact."""
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline

    cell = manifest.load_cell(CELL)
    p = cell.config["pipeline"]
    cell.traffic.update(blocks_per_dispatch=1, pool=1)
    sc = scene.synthesize(p, 2, cell.traffic, SEED, "cpu")
    assert sc.pool[0].shape == (1, 2, 8, 2 * N)
    out = TDOAPipeline(PipelineConfig(**p), device="cpu").step_split_uint8(sc.pool[0], sc.anchors)
    limits = cell.limits["limits"]
    numbers = check.compare(sc.pool[0], sc.anchors, out, tdoa.Step.from_config(p), limits["lag_pick"])
    ok, rows = check.verdict(numbers, limits)
    assert ok, rows
    assert numbers["peak_pick_db"] == 0.0
    assert np.isfinite(list(numbers.values())).all()
