"""Kernel K1's cluster design at n1 = 128 and 256 (``csrc/
fft_rows_ct_cluster.cu`` with its detect half on), replayed in numpy on
the CPU. No JAX here.

A row of n = n1·n2 samples (n2 = 8·r) is a thread-block cluster of c = 2,
4 or 8 blocks (``fft_detect.cluster_geometry``). Its forward half is the
cluster K3 (``tests/test_torch_cluster_fft.py`` replays it): block
``rank`` runs step C on slot rows [rank·n2/c, (rank+1)·n2/c), slot row sr
= k·r + s being CT row k2 = k + 8·s, and keeps their power in ``pw[sr −
rank·n2/c][k1]``. So:

- floor: the CT rows k2 ≡ 0 (mod 8), the stride-8 subsample, are slot
  rows 0 .. r−1, block 0's first r rows at any c; block 0 alone finds
  the floor from them (``floor_select``: one order statistic, or the
  bisection for a bucket of ties) and hands it to the others;
- detect: block 0 takes ``dcols0`` columns after its floor, blocks 1 ..
  c−1 the rest in quads (``fft_detect.detect_columns``); each pulls, for
  its columns and every k2, the power from block (k2 mod 8)/(8/c), row
  ((k2 mod 8) mod (8/c))·r + k2/8, with ``radius`` halo bins of the
  neighbour columns (circular), in natural order; then the sliding max,
  the gates (the confidence gate last, on each segment's best) and the
  segment partials (``ct_detect.cuh`` ``window_partials``,
  ``gate_partials``, shared with the wide design).

Checks: the replica equals ``fft_detect.detect_plain`` exactly on float32
spectra (every step is a max, a min, a count, an order statistic or a
float32 comparison) at 9216, 17408, 33792, 34816 and 66560 and at every
cluster size, every power pulled once; a wrong owner or a wrong wrap
disagrees; the floor from one order statistic equals the bisection on
tie-heavy rows of these sizes; the geometry fits every planned K1 length
with n1 = 128/256.
"""

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_detect, fft_rows
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from test_torch_cuda import DET
from test_torch_k1_cluster import bisect_floor, cluster_detect_replica, floor_by_selection, power_at
from test_torch_long_rows_radix import NO_NOTCH, PLANNED

cap_cpu_threads()

THREADS, NB = 512, 1024
LENGTHS = [9_216, 17_408, 33_792, 34_816, 66_560]
K1_NARROW = [n for n in PLANNED if ct_plan.ct_split(n)[0] in fft_rows.CLUSTER_N1]


def narrow_detect_replica(fr, fi, plan, c, dcols0, owner=None, wrap=True, pulls=None):
    """K1's cluster detect half at n1 = 128/256 with c blocks and ``dcols0``
    columns on block 0 (:func:`test_torch_k1_cluster.cluster_detect_replica`
    with ``fft_detect.detect_columns``)."""
    columns = lambda rank: fft_detect.detect_columns(rank, plan.n1, c, dcols0)
    return cluster_detect_replica(fr, fi, plan, c, columns, owner, wrap, pulls)


def edge_spectra(plan, edges, seed):
    """Float32 CT-order spectra, 3 rows of noise with peaks planted at the
    given column edges (each a first column of some block's detect
    columns, 0 among them): row 0 a bin exactly ``radius`` natural bins
    after a larger one at the end of column e − 1 (the left halo,
    circular at e = 0); row 1 a bin at the end of column e − 1 exactly
    ``radius`` bins before a larger one in column e (the right halo of the
    block before); row 2 single peaks at the first bin of column e and the
    last of column e − 1."""
    n1, n2, rad = plan.n1, plan.n2, plan.radius
    rng = np.random.default_rng(seed)
    fr = rng.normal(size=(3, n1 * n2)).astype(np.float32)
    fi = rng.normal(size=(3, n1 * n2)).astype(np.float32)

    def plant(row, k1, k2, amp):
        fr[row, k2 * n1 + k1 % n1] = np.float32(amp)

    for e in edges:
        plant(0, e - 1, n2 - rad, 80.0)
        plant(0, e, 0, 45.0)
        plant(1, e - 1, n2 - 1, 55.0)
        plant(1, e, rad - 1, 85.0)
        plant(2, e, 0, 60.0)
        plant(2, e - 1, n2 - 1, 50.0)
    return fr, fi


def _edges(n1, c, dcols0):
    return sorted({fft_detect.detect_columns(k, n1, c, dcols0)[0] for k in range(c)} | {0})


CASES = [(n, fft_detect.cluster_geometry(n).c) for n in LENGTHS] + [(17_408, 4), (17_408, 8), (33_792, 8),
                                                                     (34_816, 2), (66_560, 4)]


@pytest.mark.parametrize("n,c", CASES)
@pytest.mark.parametrize("notch", [True, False])
def test_narrow_detect_replica_equals_plain_detect(n, c, notch):
    """At each length with its own c (9216, 17408: 2; 33792, 34816: 4;
    66560: 8) and at the other cluster sizes, with the flagship's radius
    and its DC notch or none (the wrap's bins then candidates too)."""
    plan = ct_plan.detect_plan(n, **{**DET, **({} if notch else NO_NOTCH)})
    dcols0 = fft_detect.cluster_columns(plan.n1, c)
    fr, fi = edge_spectra(plan, _edges(plan.n1, c, dcols0), n + c)
    pulls = []
    ours = narrow_detect_replica(fr, fi, plan, c, dcols0, pulls=pulls)
    ref = fft_detect.detect_plain(torch.from_numpy(fr), torch.from_numpy(fi), plan)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r.numpy())
    for block in pulls:  # every power pulled exactly once, halos apart
        np.testing.assert_array_equal(block, 1)
    seg_of = lambda k1, k2: (k2 // 8) * plan.n1 + k1
    for e in _edges(plan.n1, c, dcols0):  # the planted edge peaks stand as candidates in row 2
        if plan.keep_lo <= plan.n2 * e <= plan.keep_hi:
            assert np.isfinite(ours[0][2, seg_of(e, 0)]) and ours[1][2, seg_of(e, 0)] == 0


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("radius", [7, "n2"])
def test_narrow_detect_replica_at_the_radius_limits(n, radius):
    """The least radius a detect plan takes (7: segments stay exact) and
    radius = n2 (a whole neighbour column is the halo)."""
    n2 = ct_plan.ct_split(n)[1]
    rad = n2 if radius == "n2" else radius
    plan = ct_plan.detect_plan(n, **{**DET, "min_distance_bins": rad, **NO_NOTCH})
    g = fft_detect.cluster_geometry(n, rad)
    fr, fi = edge_spectra(plan, _edges(plan.n1, g.c, g.dcols0), n + rad)
    ours = narrow_detect_replica(fr, fi, plan, g.c, g.dcols0)
    ref = fft_detect.detect_plain(torch.from_numpy(fr), torch.from_numpy(fi), plan)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r.numpy())


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("mutant", ["owner", "wrap"])
def test_narrow_detect_replica_with_a_wrong_owner_or_wrap_disagrees(mutant, n):
    plan = ct_plan.detect_plan(n, **{**DET, **NO_NOTCH})
    g = fft_detect.cluster_geometry(n)
    fr, fi = edge_spectra(plan, _edges(plan.n1, g.c, g.dcols0), 11)
    kw = {"owner": lambda k2: (power_at(k2, g.n2, g.c)[0] + 1) % g.c} if mutant == "owner" else {"wrap": False}
    bad = narrow_detect_replica(fr, fi, plan, g.c, g.dcols0, **kw)
    ref = fft_detect.detect_plain(torch.from_numpy(fr), torch.from_numpy(fi), plan)
    assert not np.array_equal(bad[0], ref[0].numpy())


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("case", ["ties", "halves", "zeros and an impulse"])
def test_floor_by_selection_equals_the_bisection_at_narrow_sizes(n, case):
    """The subsample's n/8 values (1152 .. 8320): on rows of few distinct
    values the floor from one order statistic equals the 24-step bisection
    bit for bit; a row of equal values takes the bisection itself, as a
    receiver with no signal does (zeros and an impulse: its powers are all
    equal)."""
    s = n // 8
    rng = np.random.default_rng(n)
    if case == "ties":
        db = np.round(10 * np.log10(rng.exponential(size=s)) + 42.1, 1).astype(np.float32)
    elif case == "halves":
        db = np.where(np.arange(s) % 2 == 0, np.float32(40.0), np.float32(43.0)).astype(np.float32)
    else:
        p = np.full(s, 1.0, np.float32)  # |FFT of an impulse|^2
        db = (10.0 * torch.log10(torch.from_numpy(p) + 1e-24) + 42.1).numpy()
    got, path = floor_by_selection(db, 24)
    assert got == bisect_floor(db, 24)
    assert path == ("select" if case == "ties" else "bisect"), path


def test_cluster_geometry_fits_every_planned_narrow_k1_length():
    """Every planned K1 length with n1 = 128/256 (62 + 43, 1024 ... 131072)
    takes the cluster design at the flagship's radius wherever 2 ≤ radius
    ≤ n2 (all but 1024): c the least of 2, 4, 8 for which two blocks fit
    an SM with the power buffer (up to nfft 76800), else the least for
    which one does; the column tile of the long K3 at that c, whose step B
    covers r; shared memory within 227 KB; block 0's subsample with the
    floor's histogram and bucket, and each block's natural-order columns
    with halos at radius n2, the windows' overrun and the staged partials,
    within the freed column buffer; the detect columns quads that cover n1
    once; block 0 holds slot rows 0 .. r−1 = the CT rows k2 ≡ 0 (mod 8)."""
    assert len(K1_NARROW) == 105 and K1_NARROW[0] == 1024 and K1_NARROW[-1] == 131_072
    two = lambda smem: 2 * (smem + fft_rows.CLUSTER_DETECT_STATIC_BYTES + 1024) <= 233_472
    for n in K1_NARROW:
        n1, n2 = ct_plan.ct_split(n)
        if n2 < 10:
            assert fft_detect.one_pass_design(n) is None and fft_detect.geometry(n) == "block", n
            continue
        g = fft_detect.cluster_geometry(n, n2)  # the largest radius
        assert g == fft_detect.cluster_geometry(n)._replace(smem=g.smem), n
        assert fft_detect.one_pass_design(n) == "cluster" and fft_detect.geometry(n) == "cluster", n
        assert g.c in (2, 4, 8) and (n1 // g.c) % g.cols == 0 and n2 % g.c == 0, n
        assert g.r <= 2 * 4 * {32: 8, 16: 16}[g.cols], n  # step_b_tile holds every output of a round
        assert g.smem == fft_rows.cluster_smem(n1, n2, g.c, detect=True) == (n1 // g.c * n2 + 64) * 8 + n // g.c * 4
        assert g.smem + fft_rows.CLUSTER_DETECT_STATIC_BYTES <= 232_448, n
        assert two(g.smem) == (n <= 76_800), n
        if not two(g.smem):
            assert all(fft_rows.cluster_smem(n1, n2, c, True) + 512 > 232_448 for c in (2, 4) if c < g.c), n
        else:
            assert not any(two(fft_rows.cluster_smem(n1, n2, c, True)) for c in (2, 4) if c < g.c), n
        buf = 2 * (n1 // g.c) * n2
        cols = [fft_detect.detect_columns(k, n1, g.c, g.dcols0) for k in range(g.c)]
        assert [d0 for d0, _ in cols] == list(np.cumsum([0] + [dn for _, dn in cols[:-1]])), n
        assert sum(dn for _, dn in cols) == n1 and all(dn % 4 == 0 for _, dn in cols), n
        assert all(dn > 0 for _, dn in cols[1:]) and (cols[0][1] == 0) == (g.c == 8), n
        dn = max(dn for _, dn in cols)
        assert n // 8 + NB + THREADS <= buf, n
        assert -(-dn * n2 // 128) * 128 + 2 * n2 + 8 + 2 * g.r * dn <= buf, n
        sr = np.arange(n2 // g.c)  # block 0's first r slot rows
        assert set((sr // g.r + 8 * (sr % g.r))[: g.r]) == set(range(0, n2, 8)), n
    want = {9_216: (2, 48), 17_408: (2, 48), 20_480: (4, 16), 24_576: (4, 16), 33_792: (4, 16), 34_816: (4, 32),
            66_560: (8, 0), 115_712: (8, 0)}
    assert {n: (fft_detect.cluster_geometry(n).c, fft_detect.cluster_geometry(n).dcols0) for n in want} == want
    assert fft_detect.cluster_geometry(17_408).smem == 70_144 + 34_816  # its columns and W_128, then the power


def test_design_by_emit_topk_and_radius():
    """With 2 ≤ radius ≤ n2 every n1 = 128/256 length takes the cluster
    design, 384/640/896 the wide one, with ``emit_topk`` = 1 .. 128 (T1 in
    the same launch) as without; a radius outside 2 .. n2 takes the
    one-block design up to 24576 and the long K3 → K4 above, with or
    without ``emit_topk``."""
    for n, one in ((17_408, "cluster"), (33_792, "cluster"), (34_816, "cluster"), (66_560, "cluster"),
                   (58_368, "wide"), (97_280, "wide")):
        short = n <= fft_detect.MAX_N
        assert fft_detect.geometry(n) == one, n
        for k in (1, 8, 128):
            assert fft_detect.geometry(n, emit_topk=k) == one, (n, k)
        for k in (0, 8):
            assert fft_detect.geometry(n, k, radius=1) == ("block" if short else "long"), n
            assert fft_detect.geometry(n, k, radius=ct_plan.ct_split(n)[1] + 1) == ("block" if short else "long"), n
    with pytest.raises(ValueError, match="radius"):
        fft_detect.cluster_geometry(17_408, 137)
    with pytest.raises(ValueError, match="n1"):
        fft_detect.cluster_geometry(58_368)
