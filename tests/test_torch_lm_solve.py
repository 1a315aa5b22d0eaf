"""The LM's kernel route (``ops/cuda/lm_solve.py``) on the CPU: which
path a solve takes, the wrapper's broadcast-and-flatten of every caller's
shapes to N problems and back, the layout it picks, the kernel's span
kept off the loop path, the kernel's float32 emulation
(``testing.lm_emulate``) against the loop, and the starts' tie rule. The
kernel itself runs only on the card (``tests/test_torch_cuda.py -k
lm_kernel``, where it must equal the emulation bit for bit)."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch import solver
from radio_mapper_tpu_torch.ops.cuda import lm_solve
from radio_mapper_tpu_torch.testing import cap_cpu_threads, lm_emulate, lm_problems
from radio_mapper_tpu_torch.utils import spans

cap_cpu_threads()

LOOP = solver.lm_loop  # the loop itself, whatever a test's spy puts in its place

CSRC = Path(lm_solve.__file__).resolve().parents[2] / "csrc" / "lm_solve.cu"


@pytest.fixture
def spy(monkeypatch):
    """Counts of the kernel route's and the loop's calls."""
    calls = {"kernel": 0, "loop": 0}
    kernel, loop = lm_solve.lm_solve, solver.lm_loop

    def on_kernel(*a, **k):
        calls["kernel"] += 1
        return kernel(*a, **k)

    def on_loop(*a, **k):
        calls["loop"] += 1
        return loop(*a, **k)

    monkeypatch.setattr(lm_solve, "lm_solve", on_kernel)
    monkeypatch.setattr(solver, "lm_loop", on_loop)
    return calls


def _loop_launch(anchors, dd, w, wsum, x0, pairs, iterations, solve_2d):
    """The kernel's launch stood in by the loop on the N flat problems."""
    pi, pj = pairs.long().unbind(-1)
    return LOOP(anchors, pi, pj, dd, w, wsum, x0, iterations=iterations, solve_2d=solve_2d)


def on_card(monkeypatch):
    """Every tensor counts as on the card (the route's device check), and
    the kernel's launch is stood in by the loop on the flat problems (the
    kernel runs only on the card)."""
    monkeypatch.setattr(solver, "_on_card", lambda _t: True)
    monkeypatch.setattr(lm_solve, "_launch", _loop_launch)


# -- routing -------------------------------------------------------------


@pytest.mark.parametrize("route,card,psum,kernel_calls", [
    ("cpu tensors take the loop", False, False, 0),
    ("psum takes the loop", True, True, 0),
    ("psum on the CPU takes the loop", False, True, 0),
    ("the card with no psum takes the kernel", True, False, 1),
])
def test_routing(spy, monkeypatch, route, card, psum, kernel_calls):
    anchors, pi, pj, dd, w = lm_problems((3,), 5, seed=1)
    if card:
        on_card(monkeypatch)
    solver.solve_tdoa_impl(anchors, pi, pj, dd, w, iterations=5, psum=(lambda x: x) if psum else None)
    assert spy["kernel"] == kernel_calls
    assert spy["loop"] == 1 - kernel_calls


def test_the_device_check_reads_the_device():
    assert not solver._on_card(torch.zeros(2))
    assert solver._on_card(torch.empty(2, device="meta")) is False


# -- broadcast and flatten at every caller's shapes ----------------------

# caller → (kwargs of lm_problems(), how it calls the solver)
CALLERS = {
    "pipeline flagship [D, C] x 28 pairs, 40 iterations, 2-D": (dict(lead=(2, 3), b=8), "impl", dict(iterations=40)),
    "pipeline, one block: no batch dims": (dict(lead=(), b=4), "impl", dict(iterations=40)),
    "pipeline narrowband, 4 starts x [2, C]": (dict(lead=(2, 3), b=8), "multistart", dict(iterations=40, num_starts=4)),
    "wideband [M] x 2016 pairs, anchors expanded": (dict(lead=(3,), b=64), "expanded", dict(iterations=15)),
    "streaming [M] x 6 pairs, 20 iterations": (dict(lead=(5,), b=4), "impl", dict(iterations=20)),
    "sharded tail [C, M] x 28 pairs, 15 iterations": (dict(lead=(2, 2), b=8), "impl", dict(iterations=15)),
    "engine, 4 starts of one measurement set, some pairs": (
        dict(lead=(), b=5, pairs=([1, 2, 3, 4, 2, 4], [0, 0, 0, 1, 1, 3])), "multistart",
        dict(iterations=40, num_starts=4, sigma_floor_m=np.float32(3.0))),
    "3-D, init_enu given, per-problem anchors": (dict(lead=(4,), b=6), "init3d", dict(iterations=25, solve_2d=False)),
    "weights None, three receivers": (dict(lead=(4,), b=3), "noweights", dict(iterations=40)),
}


def _solve(how, anchors, pi, pj, dd, w, kw):
    if how == "multistart":
        return solver.solve_tdoa_multistart(anchors, pi, pj, dd, w, **kw)
    if how == "expanded":
        return solver.solve_tdoa_impl(anchors.expand(*dd.shape[:-1], *anchors.shape), pi, pj, dd, w, **kw)
    if how == "init3d":
        per = anchors + torch.arange(dd.shape[0], dtype=torch.float32)[:, None, None]  # [M, B, 3]
        return solver.solve_tdoa_impl(per, pi, pj, dd, w, init_enu=torch.tensor([100.0, -50.0, 10.0]), **kw)
    if how == "noweights":
        return solver.solve_tdoa_impl(anchors, pi, pj, dd, None, **kw)
    return solver.solve_tdoa_impl(anchors, pi, pj, dd, w, **kw)


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_kernel_route_keeps_every_callers_shapes(caller, monkeypatch):
    """The kernel route's wrapper (its launch stood in by the loop over the
    N flattened problems) against the loop on the caller's own
    batch shape: every field of the result alike, shape and values. The
    same loop on the same rows, batched otherwise; the tolerances allow
    float32 sums taken in another order (a few ulps of a 10 km position,
    2e-3 m) and what they carry through 40 iterations."""
    kw_p, how, kw = CALLERS[caller]
    inputs = lm_problems(seed=7, **kw_p)
    ref = _solve(how, *inputs, kw)
    on_card(monkeypatch)
    got = _solve(how, *inputs, kw)
    for name, a, b in zip(solver.SolveResult._fields, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == torch.bool or a.dtype == torch.int64:
            assert torch.equal(a, b), name
        elif name == "position_enu":
            torch.testing.assert_close(a, b, rtol=0, atol=2e-2, msg=name)
        else:
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4, msg=name)


@pytest.mark.parametrize("shapes", [
    ((8, 3), (2, 3, 28), (2, 3, 28), (2, 3), (2, 3, 3)),
    ((4, 2, 3, 8, 3), (4, 2, 3, 28), (4, 2, 3, 28), (4, 2, 3), (4, 2, 3, 3)),
    ((3, 64, 3), (3, 2016), (3, 2016), (3,), (3, 3)),
    ((4, 3), (5, 6), (5, 6), (5,), (3,)),
    ((4, 5, 3), (10,), (4, 10), (4,), (1, 3)),
    ((4, 3), (6,), (6,), (), (3,)),
], ids=["flagship", "multistart", "wideband", "streaming", "mixed", "one problem"])
def test_flatten_problems_rows_are_the_broadcast_rows(shapes):
    gen = torch.Generator().manual_seed(3)
    anchors, dd, w, wsum, x0 = (torch.randn(s, generator=gen) for s in shapes)
    batch, (fa, fd, fw, fs, fx) = lm_solve.flatten_problems(anchors, dd, w, wsum, x0)
    assert batch == torch.broadcast_shapes(shapes[0][:-2], shapes[1][:-1], shapes[2][:-1], shapes[3], shapes[4][:-1])
    n = int(np.prod(batch))
    b, p = shapes[0][-2], shapes[1][-1]
    assert (fa.shape, fd.shape, fw.shape, fs.shape, fx.shape) == ((n, b, 3), (n, p), (n, p), (n,), (n, 3))
    assert all(t.is_contiguous() for t in (fa, fd, fw, fs, fx))
    for flat, t, tail in ((fa, anchors, (b, 3)), (fd, dd, (p,)), (fw, w, (p,)), (fs, wsum, ()), (fx, x0, (3,))):
        assert torch.equal(flat.reshape((*batch, *tail)), t.expand((*batch, *tail)))


def test_wrapper_returns_the_batch_shape_and_refuses_what_the_kernel_does_not_take(monkeypatch):
    anchors, pi, pj, dd, w = lm_problems((2, 3), 4, seed=5)
    wsum = w.sum(-1) + 1e-12
    x0 = anchors.mean(-2).expand(2, 3, 3)
    with pytest.raises(ValueError):  # the kernel takes CUDA tensors only
        lm_solve.lm_solve(anchors, pi, pj, dd, w, wsum, x0, iterations=3, solve_2d=True)
    monkeypatch.setattr(lm_solve, "_launch", _loop_launch)
    x, cost = lm_solve.lm_solve(anchors, pi, pj, dd, w, wsum, x0, iterations=3, solve_2d=True)
    assert x.shape == (2, 3, 3) and cost.shape == (2, 3)
    with pytest.raises(ValueError):
        lm_solve.lm_solve(anchors.double(), pi, pj, dd, w, wsum, x0, iterations=3, solve_2d=True)
    with pytest.raises(ValueError):
        lm_solve.lm_solve(anchors, pi[:-1], pj, dd, w, wsum, x0, iterations=3, solve_2d=True)
    with pytest.raises(ValueError):
        lm_solve.lm_solve(anchors, pi, pj, dd, w, wsum, x0, iterations=-1, solve_2d=True)


# -- layout ----------------------------------------------------------------


@pytest.mark.parametrize("p,b,want", [
    (28, 8, "thread"), (3, 3, "thread"), (55, 11, "thread"), (64, 16, "thread"),
    (66, 12, "warp"), (2016, 64, "warp"), (10, 17, "warp"),
])
def test_layout_from_pairs_and_receivers(p, b, want):
    assert lm_solve.layout(p, b) == want


def test_layout_limits_match_the_source():
    src = CSRC.read_text()
    for name in ("THREAD_MAX_PAIRS", "THREAD_MAX_RECEIVERS", "WARPS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(lm_solve, name), name


# -- spans -------------------------------------------------------------------


@pytest.mark.parametrize("psum", [False, True], ids=["cpu", "psum"])
def test_kernel_span_absent_on_the_loop_path(monkeypatch, psum):
    anchors, pi, pj, dd, w = lm_problems((3,), 5, seed=2)
    if psum:
        on_card(monkeypatch)  # psum keeps the loop even on the card
    with spans._Step(torch.device("cpu")):
        solver.solve_tdoa_impl(anchors, pi, pj, dd, w, iterations=4, psum=(lambda x: x) if psum else None)
    rec = spans.steps()[-1]
    assert [s.name for s in rec.spans] == ["step", "solve.prep", "solve.lm"]
    assert rec.host_ms("solve.lm.kernel") is None


# -- the kernel's float32 emulation against the loop ------------------------

# name → (lead, receivers, edit of lm_problems, weights given)
EMULATED = {
    "2-D": ((16,), 8, None, True),
    "weights None": ((16,), 8, None, False),
    "zero weight rows": ((16,), 8, "zero_row", True),
    "NaN measurements": ((16,), 8, "nan", True),
    "collinear receivers": ((16,), 8, "collinear", True),
    "three receivers": ((16,), 3, None, True),
    "64 receivers": ((4,), 64, None, True),
}


@pytest.mark.parametrize("lanes", [0, 32], ids=["thread order", "warp order"])
@pytest.mark.parametrize("case", sorted(EMULATED))
def test_kernel_emulation_takes_the_loops_step(case, lanes):
    """``lm_emulate`` (the kernel's arithmetic, which the kernel must equal
    bit for bit on the card) against ``solver.lm_loop`` on the same set-up,
    one iteration from the centroid: the same NaNs, positions within 2 cm
    and costs within 1e-4 relative. Basis: the two differ only in the
    order of the pair sums, a few float32 ulps of each sum, which a step
    of kilometres carries to millimetres (up to 8 mm at 64 receivers);
    2 cm is about 20 ulps of a 10 km coordinate and 1e-5 of the step, so
    a wrong formula (damping, floor, gradient, weights, the 3x3 solve)
    fails it."""
    lead, b, edit, weighted = EMULATED[case]
    anchors, pi, pj, dd, w = lm_problems(lead, b, seed=11, edit=edit)
    args = solver.lm_setup(anchors, pi, pj, dd, w if weighted else None)
    _, (fa, fd, fw, fs, fx) = lm_solve.flatten_problems(args[0], *args[3:])
    xl, cl = LOOP(fa, pi, pj, fd, fw, fs, fx, iterations=1, solve_2d=True)
    xe, ce = lm_emulate(*(t.numpy() for t in (fa, pi, pj, fd, fw, fs, fx)), iterations=1, solve_2d=True,
                        lanes=lanes)
    xl, cl = xl.numpy(), cl.numpy()
    assert np.array_equal(np.isnan(xe), np.isnan(xl)) and np.array_equal(np.isnan(ce), np.isnan(cl))
    assert np.nanmax(np.abs(xe - xl)) <= 2e-2
    assert np.nanmax(np.abs(ce - cl) / np.abs(cl)) <= 1e-4
    assert np.nanmax(np.abs(xe - fx.numpy())) > 10.0  # the step moved


# -- the starts' tie rule ------------------------------------------------------


@pytest.mark.parametrize("costs,want", [
    ([1.0 + 5e-6, 1.0, 2.0, 1.0 + 2e-6], 0),
    ([1.0 + 2e-5, 1.0, 2.0, 1.0], 1),
    ([3.0, 1.0 + 9e-6, 1.0, 5.0], 1),
    ([3.0, float("nan"), 1.0, float("nan")], 1),
    ([float("inf")] * 4, 0),
    ([5.0, 0.0, 1e-12, 0.0], 1),
], ids=["within the tie", "beyond it", "the first within", "NaN lowest", "all inf", "zero"])
def test_multistart_takes_the_first_start_within_the_tie(monkeypatch, costs, want):
    """Final costs within ``STARTS_TIE_RTOL`` (1e-5) of the lowest are a
    tie; the lowest start index in it wins, for every field."""
    anchors, pi, pj, dd, w = lm_problems((2,), 5, seed=4)

    def impl(anchors, pair_i, pair_j, dd_m, weights=None, *, init_enu, **kw):
        s = init_enu.shape[0]
        idx = torch.arange(s, dtype=torch.float32).reshape(s, 1).expand(init_enu.shape[:-1])
        cost = torch.tensor(costs).reshape(s, 1).expand(idx.shape)
        return solver.SolveResult(init_enu, cost, idx, idx, idx >= 0, idx.long(), idx[..., None, None].expand(
            *idx.shape, 3, 3), idx, idx, idx)

    monkeypatch.setattr(solver, "solve_tdoa_impl", impl)
    res = solver.solve_tdoa_multistart(anchors, pi, pj, dd, w, num_starts=len(costs))
    starts = solver.perturbed_starts(anchors, len(costs))
    assert torch.equal(res.position_enu, starts[want].expand(2, 3))
    assert (res.residual_rms_m == want).all() and (res.num_measurements == want).all()
