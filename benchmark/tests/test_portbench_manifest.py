"""BENCHMARK.json against the benchmark's contract, and every file a cell
or metric names."""

from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH, ROOT

from harness import manifest

MAN = manifest.load_manifest(ROOT)
NAME = manifest.NAME_RE
UNIT = manifest.UNIT_RE
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = {w["name"]: w for w in MAN["workloads"]}


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_command_and_paths():
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    assert cmd == ["python3", "benchmark/run.py"]
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
        assert not p.endswith("_torch")


def test_run_seconds_fit_the_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24  # the most a later PR may grow to, at this length
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert LINE.match(cfg["source"]) and LINE.match(cfg["why"])
    assert cfg["file"].startswith("benchmark/") and (ROOT / cfg["file"]).is_file()
    assert len(cfg["reduced"]) <= 16 and all(NAME.match(k) for k in cfg["reduced"])
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    assert {"num_buoys", "channels", "emitter_mix", "snr_db", "blocks_per_dispatch", "buoy_positions"} <= set(data["assumed"])
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])
    files = [c["file"] for c in MAN["configs"]]
    assert files.count(cfg["file"]) == 1


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_entry_and_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and LINE.match(cell["why"]) and NAME.match(cell["traffic"])
    assert cell["config"] in {c["name"] for c in MAN["configs"]}
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    assert (BENCH / "limits" / f"{cell['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1
    loaded = manifest.load_cell(cell["name"])
    names = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert loaded.per_layer
    assert loaded.traffic["generator"] == "scene" and LINE.match(loaded.traffic["who"])


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


@pytest.mark.parametrize("metric", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES_E2E
    assert 0.01 <= metric["bound"] <= 0.25


def test_setup_bound():
    assert E2E["setup_s"]["bound"] <= 0.25


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_and_its_reader(metric):
    assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES and LINE.match(metric["layer"])
    assert metric["moves"] in E2E
    for w in metric.get("workloads", []):
        assert w in CELLS
    spec = manifest.metric_spec(metric["name"])
    for key in ("name", "unit", "better", "source", "layer", "moves", "workloads"):
        assert spec.get(key) == metric.get(key), key
    assert (BENCH / "readers" / f"{spec['reader']}.py").is_file()
    if "work" in spec.get("args", {}):
        assert (BENCH / "work" / f"{spec['args']['work']}.py").is_file()
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_layers_named_alike():
    by_layer = {}
    for m in MAN["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_limits_cover_the_check(cell):
    from harness import check

    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())["limits"]
    assert set(limits) == set(check.NUMBERS)
    assert all(v > 0 for v in limits.values())


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_each_limit_lies_between_its_readings(cell):
    data = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())
    for name, limit in data["limits"].items():
        assert data["lower_readings"][name] < limit < data["upper_readings"][name], name
