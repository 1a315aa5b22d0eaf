"""A whole run of each cell at a tiny size on the CPU (the harness's look
for a card skipped), the result line's shape, the guard against the JAX
package, and a cell added by files alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
from conftest import BENCH, ROOT, SEED, tiny_cell

from harness import driver, guard, manifest


def _run(cell, traced=False, seconds=0.5, program=None):
    return driver.run(cell, SEED, seconds, traced, t0=time.perf_counter(), device="cpu",
                      program=program, require_chip=False, log=lambda _m: None)


def test_result_line_shape(cell_name, capsys):
    cell = tiny_cell(cell_name)
    result, rows = _run(cell)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        v = result["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and v["value"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(result)[-1] == "check"
    assert {k for k in result["check"]} == set(cell.limits["limits"])
    driver.emit(result, rows)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    tail = err.strip().splitlines()[-len(rows):]
    assert all(line.startswith("check ") and " limit " in line for line in tail)


def test_traced_run_reports_per_layer_metrics_only(cell_name):
    cell = tiny_cell(cell_name)
    result, _ = _run(cell, traced=True)
    names = {m["name"] for m in cell.per_layer}
    assert set(result["metrics"]) <= names
    assert result["correct"]
    assert not set(result["metrics"]) & {m["name"] for m in cell.end_to_end}


def test_guard_compares_top_level_names_whole():
    assert guard.forbidden_modules(["radio_mapper_tpu_torch", "radio_mapper_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert guard.forbidden_modules(["jax.numpy", "radio_mapper_tpu.ops", "flax"]) == ["flax", "jax", "radio_mapper_tpu"]


def test_a_run_loads_no_module_of_the_jax_package(tmp_path):
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_cell, SEED\n"
        "from harness import driver, guard\n"
        "r, _ = driver.run(tiny_cell('flagship.b128'), SEED, 0.2, False, t0=time.perf_counter(), device='cpu',"
        " require_chip=False, log=lambda m: None)\n"
        "print(guard.forbidden_modules())\n"
    ) % (str(BENCH / "tests"), str(BENCH))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "flagship.b128", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_run_without_the_program_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flagship.b128", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A throwaway traffic mix, per-layer metric and cell, added as new
    files and entries beside the committed ones; nothing existing edited."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    traffic = json.loads((bench / "traffic" / "b128.json").read_text())
    traffic["emitter"]["snr_db"] = [20.0, 25.0]
    (bench / "traffic" / "b8strong.json").write_text(json.dumps(traffic))
    (bench / "limits" / "flagship.b8strong.json").write_text((bench / "limits" / "flagship.b128.json").read_text())
    (bench / "readers" / "dispatch_count.py").write_text("def read(run):\n    return float(run.dispatches) or None\n")
    metric = {"name": "dispatches_traced", "unit": "count", "better": "higher", "source": "host_clock",
              "layer": "harness", "moves": "iq_msps", "workloads": ["flagship.b8strong"], "reader": "dispatch_count"}
    (bench / "metrics" / "dispatches_traced.json").write_text(json.dumps(metric))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "flagship.b8strong", "config": "flagship", "traffic": "b8strong", "chips": 1,
                             "why": "throwaway"})
    man["per_layer"].append({k: metric[k] for k in ("name", "unit", "better", "source", "layer", "moves", "workloads")})
    after = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    cell = tiny_cell("flagship.b8strong", tmp_path, man)
    assert cell.traffic["emitter"]["snr_db"] == [20.0, 25.0]
    result, _ = _run(cell, traced=True)
    assert result["correct"] and result["metrics"]["dispatches_traced"]["value"] >= 1
    assert manifest.load_cell("flagship.b128", tmp_path, man).traffic["emitter"]["snr_db"] == [10.0, 30.0]


def test_trace_summary_names_idle_gaps():
    from harness import trace

    ev = lambda name, ts, dur, cat: {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    events = [
        ev("bench.profile_window", 0, 100, "user_annotation"),
        ev("bench.dispatch", 0, 40, "user_annotation"),
        ev("bench.mark.decode", 5, 0, "user_annotation"),
        ev("bench.mark.solve", 30, 0, "user_annotation"),
        ev("bench.readback", 40, 55, "user_annotation"),
        ev("k1", 2, 8, "kernel"), ev("k2", 8, 4, "kernel"), ev("lm", 20, 10, "kernel"),
        ev("copy", 45, 5, "gpu_memcpy"), ev("late", 98, 10, "kernel"),
    ]
    t = trace.summarise(events)
    assert t.window_s == pytest.approx(100e-6) and t.busy_s == pytest.approx((10 + 10 + 5 + 2) * 1e-6)
    assert t.device_ops[0][0] in ("lm", "late")
    names = [g[0] for g in t.idle_gaps]
    assert t.idle_gaps[0] == ["readback", pytest.approx(48e-6)]
    assert "enqueue.solve" in names and "enqueue.decode" in names


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "narrowband.elt", "--seed",
                          str(SEED), "--seconds", "3", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
