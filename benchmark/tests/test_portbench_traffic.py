"""The traffic generator repeats exactly for a seed, and only for it."""

from __future__ import annotations

import pytest
import torch
from conftest import SEED, tiny_cell

from harness import scene


def _scene(cell, seed):
    return scene.synthesize(cell.config["pipeline"], cell.config["channels"], cell.traffic, seed, "cpu")


def test_a_seed_repeats_exactly(cell_name):
    cell = tiny_cell(cell_name)
    a, b = _scene(cell, SEED), _scene(cell, SEED)
    assert len(a.pool) == cell.traffic["pool"]
    for x, y in zip(a.pool, b.pool):
        assert x.dtype == torch.uint8 and torch.equal(x, y)
    assert torch.equal(a.anchors, b.anchors)
    assert all(torch.equal(x, y) for x, y in zip(a.truth, b.truth))


def test_another_seed_gives_the_same_sizes_other_values(cell_name):
    cell = tiny_cell(cell_name)
    a, b = _scene(cell, SEED), _scene(cell, SEED + 1)
    assert [x.shape for x in a.pool] == [x.shape for x in b.pool]
    assert not torch.equal(a.pool[0], b.pool[0])
    assert not torch.equal(a.anchors, b.anchors)


def test_pool_entries_and_channel_blocks_are_distinct(cell_name):
    cell = tiny_cell(cell_name)
    s = _scene(cell, SEED)
    flat = torch.cat([x.reshape(-1, *x.shape[-2:]) for x in s.pool])
    assert len({bytes(row.numpy().tobytes()) for row in flat}) == flat.shape[0]


def test_shapes_and_geometry(cell_name):
    cell = tiny_cell(cell_name)
    p, t = cell.config["pipeline"], cell.traffic
    s = _scene(cell, SEED)
    n = p["block_len"] * p["correlation_dwells"]
    lead = (t["blocks_per_dispatch"], cell.config["channels"]) if t["blocks_per_dispatch"] else (cell.config["channels"],)
    assert s.lead == lead
    assert s.pool[0].shape == (*lead, p["num_buoys"], 2 * n)
    assert s.samples_per_dispatch == torch.tensor(lead).prod().item() * p["num_buoys"] * n
    r = s.anchors[:, :2].norm(dim=-1)
    lo, hi = t["network"]["buoy_radius_m"]
    assert bool(((r >= lo - 1) & (r <= hi + 1)).all()) and bool((s.anchors[:, 2] == 0).all())
    assert bool((s.truth[0][..., :2].norm(dim=-1) <= t["emitter"]["radius_m"] + 1).all())


def test_quantised_like_the_dongle(cell_name):
    cell = tiny_cell(cell_name)
    x = _scene(cell, SEED).pool[0].to(torch.float64) - 127.5
    rms = x.pow(2).reshape(-1, x.shape[-2] * x.shape[-1]).mean(-1).mul(2).sqrt()
    assert torch.allclose(rms, torch.full_like(rms, cell.traffic["quantize_rms_counts"]), rtol=0.05)


@pytest.mark.parametrize("seed", [0, 2**31 - 1, 2**31 + 5, 2**40 + 3, 2**63 + 11])
def test_large_seeds(seed):
    cell = tiny_cell("flagship.b128")
    cell.traffic.update(pool=1)
    assert _scene(cell, seed).pool[0].numel() > 0
