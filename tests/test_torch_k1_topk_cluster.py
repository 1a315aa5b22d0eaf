"""Kernel K1's in-kernel top-K (``emit_topk = K``, T1) on its cluster
designs, replayed in numpy on the CPU. No JAX here.

The reference's selection (``detect_kernel._detect_body`` with
``emit_topk``, the one-block K1's ``block_topk``) runs K masked-argmax
passes over a row's s = n/8 gated segment scores: pass j takes the max m
and the lowest segment f holding it, writes (m, 8·f + seg_arg[f]) and
sets the score to −inf. So its lanes are the segments of score > −inf in
the order (score descending, f ascending); once they run out every pass
takes f = 0: (−inf, seg_arg[0]). Lanes K .. 127 are 0.

In the cluster designs (``csrc/fft_rows_ct_cluster.cu`` at n1 = 128/256,
a row on c = 2, 4 or 8 blocks; ``csrc/fft_detect_cluster.cuh`` at 384,
640, 896, on 8) each block holds the partials of its detect columns [d0,
d0 + dn) before the confidence gate, in staged order g = b2·dn + c
(segment f = b2·n1 + d0 + c, increasing in g), and ``ct_detect.cuh``
selects:

- block, before the floor arrives: for K ≤ 8 (``topk_block8``, the
  flagship's K) thread t holds g = t + 512i, the K-th largest of the 16
  warps' largest scores is a threshold at or below the block's K-th, and
  one warp ranks the segments at or above it (more than 32: as for larger
  K); for larger K (``topk_block``) warp w takes g in
  [w·chunk, (w + 1)·chunk) (16 warps, chunk = ⌈r·dn/16⌉) and lists its
  first min(K, chunk) segments in (score, g) order, and an entry's rank
  in the block is its place in its warp's list plus, for each other
  warp, the entries before it there (a larger score, or an equal one in a
  warp of lower g); the first K, with their f and offset, are the
  block's list;
- cluster: the block that holds column 0 gates the c lists with the
  floor (the gate is monotone in the score: a list's passing entries are
  its first) and merges them the same way in (score, f) order
  (``topk_stage``, ``topk_write``): lane rank < K gets (score, 8·f +
  offset); lanes from the passing total to K get (−inf, segment 0's gated
  offset, its own).

Checks: the replica, fed each block's partials before the gate from
``test_torch_k1_cluster_narrow.narrow_detect_replica`` and
``test_torch_k1_cluster.wide_detect_replica`` run without the gate (with
it they equal ``fft_detect.detect_plain``), equals ``fft_detect.topk_plain``
on ``detect_plain``'s partials exactly, at c = 2, 4, 8 and at the wide
design's n1, for K = 1, 8, 128, on tone rows, rows with no candidate,
rows with fewer candidates than K (segment 0 holding one at offset 3) and
rows with equal powers in segments of different blocks; a merge that
fills the exhausted lanes from a block's own padding, and one that breaks
ties by block order, disagree; the design takes the top-K at every
planned length and every K.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import fft_detect, fft_rows
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from test_torch_cuda import DET
from test_torch_k1_cluster import detect_columns as wide_columns, wide_detect_replica
from test_torch_k1_cluster_narrow import _edges, edge_spectra, narrow_detect_replica
from test_torch_long_rows_radix import NO_NOTCH, PLANNED, _planted_spectra

cap_cpu_threads()

WARPS, LANES = 16, 128
NARROW = [9_216, 17_408, 20_480, 33_792, 34_816, 66_560]  # c = 2, 2, 4, 4, 4 (n1 = 256), 8
WIDE = [58_368, 97_280, 121_856]  # n1 = 384, 640, 896
KS = [1, 8, 128]
CASES = ["tones", "none", "few", "ties"]
NO_CANDIDATE = {"confidence_floor": 1.5}  # above 1: an infinite threshold, no bin passes
FEW = {"confidence_floor": 1.0}  # 20 dB over the floor: the planted peaks pass, no noise bin does


def shape(n):
    """``(c, columns)``: the design's blocks a row and ``columns(rank) ->
    (d0, dn)``."""
    n1 = ct_plan.ct_split(n)[0]
    if n1 in fft_rows.CLUSTER_N1:
        g = fft_detect.cluster_geometry(n)
        return g.c, lambda rank: fft_detect.detect_columns(rank, n1, g.c, g.dcols0)
    return fft_rows.WIDE_C, lambda rank: wide_columns(rank, n1)


def staged(plan, d0, dn):
    """A block's staged order: segment f of staged index g = b2·dn + c."""
    g = np.arange(plan.n2 // 8 * dn)
    return (g // dn) * plan.n1 + d0 + g % dn


def _ranks(lists, b, lower):
    """The ranks of list b's entries in the merge of ``lists`` (each
    ``(scores, tie keys)``, in order): an entry's place in its list plus,
    for each other list u, its entries before it: a larger score, or an
    equal one that ``lower(u, u's keys [1, m], the entries' keys [n, 1])``
    puts first."""
    lv, lk = lists[b]
    rank = np.arange(len(lv))
    for u, (uv, uk) in enumerate(lists):
        if u != b:
            eq = (uv[None, :] == lv[:, None]) & lower(u, uk[None, :], lk[:, None])
            rank = rank + np.count_nonzero(uv[None, :] > lv[:, None], axis=1) + np.count_nonzero(eq, axis=1)
    return rank


def block_list(score, arg, f, k):
    """One block's list on one row (``topk_block``) from its gated partials
    in staged order: ``(values, f, offsets)``, at most k, in (score, f)
    order, through its warps' lists and their rank merge."""
    s = score.size
    chunk = -(-s // WARPS)
    kw = min(k, chunk)
    lists = []
    for w in range(WARPS):
        g = np.arange(w * chunk, min(s, (w + 1) * chunk))
        g = g[score[g] > -np.inf]
        g = g[np.lexsort((g, -score[g]))][:kw]  # by score descending, then g
        lists.append((score[g], g))
    out = [None] * min(k, sum(len(v) for v, _ in lists))
    for w, (lv, lg) in enumerate(lists):
        for rank, v, g in zip(_ranks(lists, w, lambda u, uk, key: np.full(np.broadcast(uk, key).shape, u < w)), lv, lg):
            if rank < k:
                out[rank] = (v, f[g], arg[g])
    return out


def block_list8(score, arg, f, k, path=None):
    """``topk_block8`` (k ≤ 8) on one row: thread t's segments g = t +
    512i (i < 8), warp w's those of its 32 threads; the threshold tau, the
    k-th largest of the warps' largest scores (none where fewer than k
    warps hold a candidate); the segments at or above it gathered and
    ranked (score descending, then the lower g) where at most 32, else
    ``topk_block``'s list (:func:`block_list`); the first k. ``path`` (a
    list) gets "gather" or "passes"."""
    s = score.size
    order = lambda g: g[np.lexsort((g, -score[g]))]  # by score descending, then g
    g = np.arange(s)
    valid = score > -np.inf
    maxima = [score[g[valid & ((g % 512) // 32 == w)]].max(initial=-np.inf) for w in range(16)]
    tau = sorted(maxima, reverse=True)[k - 1]
    gathered = g[valid & (score >= tau)]
    if path is not None:
        path.append("gather" if len(gathered) <= 32 else "passes")
    if len(gathered) > 32:
        return block_list(score, arg, f, k)
    return [(score[g], f[g], arg[g]) for g in order(gathered)[:k]]


def topk_replica(score, arg, conf, plan, c, columns, k, exhaust="segment 0", ties="f"):
    """The cluster designs' top-K on the row partials ``score, arg`` [rows,
    n/8] before the confidence gate, whose linear level is ``conf`` [rows]
    (None: no gate): ``(vals, packed)`` [rows, 128]. ``exhaust="padding"``:
    the exhausted lanes take the last block's own padding (its first
    segment); ``ties="block"``: equal scores merge in block order."""
    rows = score.shape[0]
    vals = np.zeros((rows, LANES), np.float32)
    packed = np.zeros((rows, LANES), np.float32)
    blocks = [columns(rank) for rank in range(c)]
    for row in range(rows):
        passes = lambda v: np.ones(np.shape(v), bool) if conf is None else v + np.float32(1e-24) >= conf[row]
        lists = []
        for d0, dn in blocks:
            f = staged(plan, d0, dn)
            got = (block_list8 if k <= fft_detect.TOPK_FAST else block_list)(score[row, f], arg[row, f], f, k)
            lv, lf, la = (np.array([e[0] for e in got], np.float32), np.array([e[1] for e in got], np.int64),
                          np.array([e[2] for e in got], np.float32))
            keep = passes(lv)
            assert keep.all() or not keep[np.argmin(keep):].any()  # the passing entries come first
            lists.append((lv[keep], lf[keep], la[keep]))
        keyed = [(lv, lf) for lv, lf, _ in lists]
        total = sum(len(lv) for lv, _ in keyed)
        for b, (lv, lf, la) in enumerate(lists):
            if ties == "block":
                lower = lambda u, uk, key, b=b: np.full(np.broadcast(uk, key).shape, u < b)
            else:
                lower = lambda u, uk, key: uk < key
            for rank, v, f, a in zip(_ranks(keyed, b, lower), lv, lf, la):
                if rank < k:
                    vals[row, rank] = v
                    packed[row, rank] = np.float32(8 * f) + a
        first = 0 if exhaust == "segment 0" else blocks[-1][0]
        vals[row, min(k, total):k] = -np.inf
        packed[row, min(k, total):k] = np.float32(8 * first) + (arg[row, first] if passes(score[row, first]) else 0)
    return vals, packed


def spectra(plan, case, seed):
    """Float32 CT-order spectra [3, n] for ``case``: "tones" the halo and
    edge peaks of the detect replicas' tests; otherwise unit noise with
    peaks planted at CT (k2, k1): "none" none, "few" three (and, in row
    1, natural bin 3: segment 0's offset 3), "ties" two equal ones in
    segments of two blocks whose f order is the reverse of their blocks'
    (the first block's at b2 = 1, the later block's at b2 = 0) above two
    others."""
    n1, n2 = plan.n1, plan.n2
    if case == "tones":
        if n1 in fft_rows.CLUSTER_N1:
            g = fft_detect.cluster_geometry(plan.nfft)
            return edge_spectra(plan, _edges(n1, g.c, g.dcols0), seed)
        return _planted_spectra(plan, seed)
    rng = np.random.default_rng(seed)
    fr = rng.normal(size=(3, n1 * n2)).astype(np.float32)
    fi = rng.normal(size=(3, n1 * n2)).astype(np.float32)

    def plant(row, k2, k1, amp):
        fr[row, k2 * n1 + k1], fi[row, k2 * n1 + k1] = np.float32(amp), np.float32(0.0)

    c, columns = shape(plan.nfft)
    (a0, an), (b0, bn) = [columns(rank) for rank in range(c) if columns(rank)[1]][:2]
    for row in range(3):
        if case == "few":
            for k2, k1, amp in ((11, a0 + 1, 900.0), (27, b0 + 2, 700.0), (40, n1 - 3, 500.0)):
                plant(row, k2, k1, amp + row)
            if row == 1:
                plant(row, 3, 0, 800.0)  # natural bin 3: segment 0, offset 3
        elif case == "ties":
            plant(row, 8 + 3, a0 + 5, 1000.0)  # the first block, b2 = 1: f = n1 + a0 + 5
            plant(row, 3, b0 + 1, 1000.0)  # the later block, b2 = 0: f = b0 + 1, lower
            plant(row, 40, b0 + 2, 900.0 - row)
            plant(row, 70, a0 + 2, 600.0)
    return fr, fi


def _detect_replica(fr, fi, plan):
    if plan.n1 in fft_rows.CLUSTER_N1:
        g = fft_detect.cluster_geometry(plan.nfft)
        return narrow_detect_replica(fr, fi, plan, g.c, g.dcols0)
    return wide_detect_replica(fr, fi, plan)


@functools.lru_cache(maxsize=64)
def partials(n, case):
    """``(plan, score, arg, ungated score, ungated arg, conf)``: the cluster
    design's partials (its detect replica) on ``spectra(case)``, gated
    (checked against ``fft_detect.detect_plain`` exactly) and before the
    confidence gate, and the gate's linear level a row (None without)."""
    extra = {"tones": {}, "none": NO_CANDIDATE, "few": {**FEW, **NO_NOTCH}, "ties": FEW}[case]
    plan = ct_plan.detect_plan(n, **{**DET, **extra})
    fr, fi = spectra(plan, case, n + len(case))
    score, arg, nf, _ = _detect_replica(fr, fi, plan)
    ref = fft_detect.detect_plain(torch.from_numpy(fr), torch.from_numpy(fi), plan)
    np.testing.assert_array_equal(score, ref[0].numpy())
    np.testing.assert_array_equal(arg, ref[1].numpy())
    u_score, u_arg, *_ = _detect_replica(fr, fi, dataclasses.replace(plan, conf_cs=None))
    conf = None
    if plan.conf_cs is not None:
        conf = torch.exp((torch.from_numpy(nf) - plan.power_offset_db + plan.conf_cs) * ct_plan.LN10_OVER_10).numpy()
    return plan, score, arg, u_score, u_arg, conf


def plain_topk(score, arg, k):
    return [x.numpy() for x in fft_detect.topk_plain(torch.from_numpy(score), torch.from_numpy(arg), k)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NARROW + WIDE)
def test_topk_replica_equals_the_reference_selection(n, k, case):
    plan, score, arg, u_score, u_arg, conf = partials(n, case)
    c, columns = shape(n)
    ours = topk_replica(u_score, u_arg, conf, plan, c, columns, k)
    ref = plain_topk(score, arg, k)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r)
    cands = np.count_nonzero(score > -np.inf, axis=-1)
    if case == "none":
        assert not cands.any() and np.isinf(ours[0][:, :k]).all() and not ours[1].any()
    if case == "few":  # fewer candidates than K but at K = 1: the lanes past them hold segment 0's offset
        assert (cands == [3, 4, 3]).all() and arg[1, 0] == 3
        assert (ours[1][1, 4:k] == 3).all() and (ours[1][[0, 2], 3:k] == 0).all()
    if case == "ties":  # the equal pair leads, the later block's (lower f) first
        f = ours[1][:, :2].astype(np.int64) // 8
        assert (ours[0][:, 0] == np.float32(1e6)).all() and (f[:, 0] < plan.n1).all()
        if k > 1:
            assert (ours[0][:, 1] == ours[0][:, 0]).all() and (f[:, 1] > plan.n1).all()


@pytest.mark.parametrize("case", ["tones", "ties", "flat"])
@pytest.mark.parametrize("n", [17_408, 33_792, 66_560, 58_368, 121_856])
def test_both_block_selections_give_the_same_list(n, case):
    """``topk_block8``'s threshold and gathered ranks and ``topk_block``'s
    warp passes and rank merge list the same segments at K = 1 .. 8; rows
    of equal scores ("flat": every third segment a candidate of one score)
    gather more than 32 and take ``topk_block``."""
    plan, _, _, u_score, u_arg, _ = partials(n, "tones" if case == "flat" else case)
    if case == "flat":
        u_score = np.where(np.arange(u_score.shape[1]) % 3 == 0, np.float32(7.0), np.float32(-np.inf))[None, :]
        u_score = np.repeat(u_score, 2, axis=0).astype(np.float32)
    c, columns = shape(n)
    paths = []
    for d0, dn in (columns(rank) for rank in range(c) if columns(rank)[1]):
        f = staged(plan, d0, dn)
        for row in range(u_score.shape[0]):
            for k in (1, 5, 8):
                a = block_list(u_score[row, f], u_arg[row, f], f, k)
                b = block_list8(u_score[row, f], u_arg[row, f], f, k, paths)
                assert [(float(v), int(ff), float(x)) for v, ff, x in a] == \
                       [(float(v), int(ff), float(x)) for v, ff, x in b]
    assert set(paths) == ({"passes"} if case == "flat" else {"gather"}), set(paths)


@pytest.mark.parametrize("n", [17_408, 66_560, 97_280])
@pytest.mark.parametrize("k", [8, 128])
def test_topk_replica_filling_exhausted_lanes_from_a_block_padding_disagrees(n, k):
    """The lanes past a row's candidates come from segment 0 (the column-0
    block's), not from a block's own first segment."""
    plan, score, arg, u_score, u_arg, conf = partials(n, "few")
    c, columns = shape(n)
    bad = topk_replica(u_score, u_arg, conf, plan, c, columns, k, exhaust="padding")
    ref = plain_topk(score, arg, k)
    assert np.array_equal(bad[0], ref[0]) and not np.array_equal(bad[1], ref[1])


@pytest.mark.parametrize("n", [17_408, 33_792, 66_560, 58_368])
@pytest.mark.parametrize("k", [1, 8])
def test_topk_replica_breaking_ties_by_block_order_disagrees(n, k):
    """Equal scores merge by segment f, not by the blocks' order."""
    plan, score, arg, u_score, u_arg, conf = partials(n, "ties")
    c, columns = shape(n)
    bad = topk_replica(u_score, u_arg, conf, plan, c, columns, k, ties="block")
    ref = plain_topk(score, arg, k)
    assert not np.array_equal(bad[1], ref[1])


def test_wide_columns_match_the_kernel_split():
    for n1 in fft_rows.WIDE_N1:
        assert [fft_detect.wide_columns(k, n1) for k in range(8)] == [wide_columns(k, n1) for k in range(8)]


@pytest.mark.parametrize("k", KS)
def test_topk_takes_the_one_pass_design_at_every_planned_length(k):
    """At every planned length (and radius 2, 10, n2) K1 with ``emit_topk``
    takes the design it takes without: the cluster design at n1 = 128/256,
    the wide one at 384/640/896 (its scratch fits, ``fft_detect.topk_fits``),
    neither at 1024 (n2 = 8, whose floor scratch does not fit a cluster);
    ``"block"`` and ``"long"`` only there and for a radius outside 2 ..
    n2."""
    for n in PLANNED:
        n1, n2 = ct_plan.ct_split(n)
        for radius in (2, 10, n2):
            one = fft_detect.one_pass_design(n, 0, radius)
            assert fft_detect.one_pass_design(n, k, radius) == one, (n, radius)
            assert fft_detect.geometry(n, k, radius) == (one or "block"), (n, radius)
            want = {128: "cluster", 256: "cluster"}.get(n1, "wide") if radius <= n2 and n > 1024 else None
            assert one == want, (n, radius)
        short = n <= fft_detect.MAX_N
        assert fft_detect.geometry(n, k, n2 + 1) == ("block" if short else "long"), n
    assert [fft_detect.geometry(1024, kk) for kk in (0, k)] == ["block"] * 2  # n2 = 8 < radius 10
