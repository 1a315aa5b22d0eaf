"""Shared helpers of the benchmark's CPU tests: the harness on the path and
each cell cut to a size the CPU runs in seconds."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(2)

from harness import manifest  # noqa: E402

CELLS = [w["name"] for w in manifest.load_manifest(ROOT)["workloads"]]
SEED = 2**31 + 4321  # beyond 32 signed bits, as a benchmark run's seed may be


def tiny_cell(name: str, root: Path = ROOT, man: dict | None = None) -> manifest.Cell:
    """The cell ``name`` with its widths kept and its sizes cut: 3 channels,
    short blocks, 2 blocks a dispatch where it has a dispatch axis."""
    cell = manifest.load_cell(name, root, man)
    p = cell.config["pipeline"]
    if p["correlation_dwells"] == 1:
        p.update(block_len=4096, max_lag=128)
    else:
        p.update(block_len=1024, max_lag=128, correlation_dwells=4)
    if cell.traffic["blocks_per_dispatch"]:
        cell.traffic["blocks_per_dispatch"] = 2
    cell.config["channels"] = 3
    cell.traffic.update(pool=2, check_dispatches=2)
    # the network shrunk with max_lag: every baseline (at most 12 km, 96
    # samples) inside the lag window, so that fixes are sound
    cell.traffic["network"] = {"buoy_radius_m": [3000.0, 6000.0]}
    cell.traffic["emitter"]["radius_m"] = 3000.0
    return cell


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
