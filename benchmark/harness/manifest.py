"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the checkout's root lists configurations, cells
("workloads") and metrics; everything else is found by name under
``benchmark/``:

- ``configs/<config>.json``: one deployment, with the step's settings;
- ``traffic/<traffic>.json``: one traffic mix, read by the generator it
  names (``harness/scene.py``);
- ``limits/<workload>.json``: the limits of the cell's correctness check;
- ``metrics/<metric>.json``: one per-layer metric, naming its reader
  (``readers/<reader>.py``) and the reader's arguments;
- ``work/<stage>.py``: the least FLOPs and bytes of a stage with a roofline.

Adding a configuration, a traffic mix, a metric or a stage count is adding
files and entries; no file that exists needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    """One workload with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def metric_spec(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "metrics" / f"{name}.json")


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "readers" / f"{name}.py", f"bench_reader_{name}")


def work(stage: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "work" / f"{stage}.py", f"bench_work_{stage.replace('.', '_')}")


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(workload: str, root: Path = ROOT, manifest: dict | None = None) -> Cell:
    """The workload ``workload`` of the manifest and the files it names."""
    man = manifest if manifest is not None else load_manifest(root)
    bench_dir = root / "benchmark"
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    cfg_entry = configs[w["config"]]
    config = _json(root / cfg_entry["file"])
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _json(bench_dir / "limits" / f"{workload}.json")
    e2e = [m for m in man["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, workload, e2e_names)]
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic, limits=limits,
        end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir,
    )
