"""The long-row design of kernel K3, kernel K4's column tiling (and so K1's
long rows), replayed in numpy on the CPU, and the routing walk over every
planned FFT length.

K3's long rows run the steps of ``csrc/ct_fft.cuh`` on a row of n = n1·n2
samples, n1 = 128, 256, 384, 640 or 896. :func:`k3_long_schedule` replays
them in the two-pass form of the workspace design (``csrc/
fft_rows_ct_long.cu``, built at n1 = 384, 640, 896 as the wide design's
comparison; its per-value arithmetic is every long design's, the wide
design of ``csrc/fft_detect_cluster.cuh`` is replayed against it by
``tests/test_torch_k1_cluster.py``, and the cluster design of
``csrc/fft_rows_ct_cluster.cu``, n1 = 128, 256, is replayed against it,
value for value, by ``tests/test_torch_cluster_fft.py``):

- column pass: a tile of ``cols`` columns p (32, or 16 for n2 > 512),
  ``tile[q][p] = x[q·n1 + p0 + p]``, step A on it with W_128^e read as
  W_n1^(e·n1/128), then step B, and slot row ``s + r·k`` times the row
  twiddle to ``ws[(s + r·k)·n1 + p0 + p]``;
- row pass: one warp a slot row, lane l holding positions P·l + i (P =
  n1/32): five radix-2 DIF stages across lanes and the P-point transform
  in registers (``tests/test_torch_mixed_radix.py``), after which
  register i holds bin digit(i)·32 + brev5(l), stored at CT address
  ``(k + a·s)·n1 + k1``.

K4 (``csrc/detect_ct.cu``): phase a writes the stride-8
subsample's dB values to ``sub[(k2/8)·n1 + k1]`` and bisects the floor;
phase b walks tiles of 16 columns k1, lays their power out in natural
order with a halo of ``radius`` bins from the neighbour columns (circular
at k1 = 0 and n1 − 1) and runs the sliding max, the gates and the
segment partials.

Tolerances: the K3 replica within 1e-5 of each row's max |X| of
``np.fft.fft`` in CT order (float32 radix-2 stages and a direct DFT of at
most 127 points), and equal, value for value, to the one-block replica
where both designs take the length (the same per-value arithmetic); the
K4 replica equal to ``fft_detect.detect_plain`` exactly on the same
float32 spectra (every step is a max, a min, a count or a float32
comparison).
"""


import numpy as np
import pytest
import torch

from radio_mapper_tpu_torch.ops import ct_plan, detect
from radio_mapper_tpu_torch.ops import split_complex as sc
from radio_mapper_tpu_torch.ops.cuda import channel_step, detect_ct, fft_detect, fft_rows, gcc_pair
from radio_mapper_tpu_torch.testing import cap_cpu_threads
from test_torch_cuda import DET
from test_torch_fft_radix import _bitrev, _c64, k3_schedule
from test_torch_mixed_radix import digit, warp_forward_fft

cap_cpu_threads()

TILE = 16  # detect_ct.TILE
STREAM_MAX_SJ = 12  # ct_fft.cuh: outputs a thread holds in the streamed step B
WARPS = 16  # ct_fft.cuh THREADS / 32


def _dif(v, w, nw):
    """In-place radix-2 DIF over the list of planes ``v`` with the table
    ``w`` of W_nw^e (e < nw/2): the pair (t, t + h) becomes (a + b,
    (a − b)·W_nw^((t mod h)·nw/(2h))). Position t then holds output
    bitrev(t)."""
    h = len(v) // 2
    while h >= 1:
        for t in range(len(v)):
            if t & h:
                continue
            a, b = v[t], v[t + h]
            e = (t & (h - 1)) * (nw // 2 // h)
            v[t] = a + b
            v[t + h] = (a - b) * w[e] if e else a - b
        h //= 2
    return v


def long_tables(n1: int, n2: int):
    """``(a, r, w1, wn2, wr, tw)`` complex64 for the split n1·n2: from
    ``ct_plan`` where ``ct_split`` gives that split, else built the same
    way (float64 roots rounded once; the twiddle as ``ct_constants``')."""
    n = n1 * n2
    if ct_plan.ct_split(n) == (n1, n2):
        t = ct_plan.radix_tables(n)
        *_, twre, twim = ct_plan.ct_constants(n)
        return t.a, t.r, _c64(t.w1), _c64(t.wn2), _c64(t.wr), (twre + 1j * twim).astype(np.complex64)
    a = min(8, n2 & -n2)
    r = n2 // a
    jr = np.arange(r)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n).astype(np.complex64)
    return (a, r, _c64(ct_plan._roots(np.arange(n1 // 2), n1)), _c64(ct_plan._roots(np.arange(n2), n2)),
            _c64(ct_plan._roots(np.outer(jr, jr) % r, r)), tw)


def column_tile(n2: int) -> int:
    """The replica's column tile: 32 columns for n2 ≤ 512, else 16 (any
    width gives the same values: steps A and B work column by column)."""
    return 32 if n2 <= 512 else 16


def ct_address(sr, i, lane, n1, a, r):
    """``rm_fft::ct_address<n1>``: CT address of value i of lane ``lane``'s
    step-C output of slot row sr = s + r·k."""
    k, s = sr // r, sr % r
    return (k + a * s) * n1 + digit(n1 // 32, i) * 32 + _bitrev(lane, 5)


def k3_long_schedule(x: np.ndarray, n1: int, n2: int) -> np.ndarray:
    """The long K3's column and row passes on complex64 rows ``x [rows, n]``."""
    rows, n = x.shape
    a, r, w1, wn2, wr, tw = long_tables(n1, n2)
    w128 = w1[:: n1 // 128]  # the column pass's step-A table: W_n1^(e·n1/128), e < 64
    cols = column_tile(n2)
    flat = x.reshape(rows, n).astype(np.complex64)
    ws = np.full((rows, n2 * n1), np.nan, np.complex64)  # [rows, n2, n1] slot rows, flat
    q, p = np.divmod(np.arange(cols * n2), cols)
    for p0 in range(0, n1, cols):
        tile = flat[:, q * n1 + p0 + p].reshape(rows, n2, cols)  # tile[q][p]
        abits = a.bit_length() - 1
        for j in range(r):  # step A
            v = _dif([tile[:, j + r * u].copy() for u in range(a)], w128, 128)
            for u in range(a):
                k = _bitrev(u, abits)
                tile[:, j + r * k] = v[u] * wn2[j * k] if k else v[u]
        for k in range(a):  # step B, written to the workspace
            y = tile[:, r * k:r * (k + 1)].copy()
            for s in range(r):
                acc = np.zeros((rows, cols), np.complex64)
                for j in range(r):
                    acc += wr[j, s] * y[:, j]
                ws[:, (s + r * k) * n1 + p0 + np.arange(cols)] = acc * tw[k + a * s, p0:p0 + cols]
    assert not np.isnan(ws).any()
    # row pass: register i of lane l of slot row sr holds bin digit(i)·32 + brev5(l)
    pp = n1 // 32
    v = warp_forward_fft(ws.reshape(rows, n2, 32, pp), n1)
    out = np.full((rows, n), np.nan, np.complex64)
    for lane in range(32):
        for i in range(pp):
            m = np.array([ct_address(sr, i, lane, n1, a, r) for sr in range(n2)])
            out[:, m] = v[:, :, lane, i]
    assert not np.isnan(out).any()
    return out


def _rows(n, seed, rows=2):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, n)) + 1j * rng.normal(size=(rows, n))).astype(np.complex64)
    x[-1, n // 3:] += 30 * np.exp(2j * np.pi * 411 * np.arange(n - n // 3) / n)  # a strong tone
    return x


def _ct_fft(x, n1, n2):
    """``np.fft.fft`` in CT order for the split n1·n2 (bin k2 + n2·k1 at
    k2·n1 + k1)."""
    perm = (np.arange(n2)[:, None] + n2 * np.arange(n1)[None, :]).reshape(-1)
    return np.fft.fft(x.astype(np.complex128))[..., perm]


@pytest.mark.parametrize("n1,n2", [
    (128, 264),  # 33792: a 8, r 33 (streamed), the flagship at block_len 32768
    (256, 136),  # 34816: a 8, r 17, n1 = 256
    (128, 520),  # 66560: a 8, r 65, 16-column tiles
    (128, 54),   # a 2, r 27 (streamed)
    (128, 60),   # a 4, r 15
    (256, 40),   # a 8, r 5
    (256, 52),   # a 4, r 13
    (256, 50),   # a 2, r 25 (streamed)
    (256, 64),   # a 8, r 8
    (384, 136),  # 52224: P = 12, a 8, r 17, the first planned mixed length
    (384, 264),  # 101376: r 33 (streamed)
    (640, 152),  # 97280: P = 20, r 19
    (896, 136),  # 121856: P = 28, r 17
])
def test_long_k3_replica_equals_numpy_fft_in_ct_order(n1, n2):
    x = _rows(n1 * n2, n1 + n2)
    ours = k3_long_schedule(x, n1, n2)
    ref = _ct_fft(x, n1, n2)
    scale = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(ours - ref).max(axis=-1, keepdims=True) <= 1e-5 * scale).all()


@pytest.mark.parametrize("n", [5120, 17408, 24576])
def test_long_k3_replica_equals_one_block_replica(n):
    """Where both designs take the length, they give the same values: the
    per-value arithmetic of steps A, B and C is the same, only the data
    movement differs (the card test holds the kernels to this bit for bit)."""
    x = _rows(n, n + 5)
    n1, n2 = ct_plan.ct_split(n)
    np.testing.assert_array_equal(k3_long_schedule(x, n1, n2), k3_schedule(x))


def tile_step_b_outputs(cols: int, r: int):
    """The long design's step B map (``fft_rows_ct_cluster.cu``
    ``step_b_tile``) on a tile of ``cols`` columns (32 or 16): for each
    thread and round, ``(k, [p, p + 1], [s, ...])``. A lane takes the
    column pair p = 2·(lane mod cols/2); owner o (a group of cols/2 lanes,
    32 or 64 a block) takes, in round u = 0, 1, column block k = o //
    PER_K + 4·u (PER_K = owners / 4) and the output pairs sp = sub +
    PER_K·i (i < 4, outputs 2·sp and 2·sp + 1), one pass over the inputs
    a pair, skipped once sp ≥ ceil(r/2); the outputs it stores are those
    below r."""
    lanes = cols // 2
    owners = WARPS * (32 // lanes)
    per_k, rh = owners // 4, (r + 1) // 2
    out = []
    for t in range(512):
        lane, warp = t % 32, t // 32
        owner = warp * (32 // lanes) + lane // lanes
        sub = owner % per_k
        pairs = [sub + per_k * i for i in range(4) if sub + per_k * i < rh]
        assert all(sp * 2 + 1 < r + (r & 1) for sp in pairs)  # the root loads stay in a row of wp
        p = 2 * (lane % lanes)
        for k in (owner // per_k, owner // per_k + 4):
            out.append((k, [p, p + 1], [s for sp in pairs for s in (2 * sp, 2 * sp + 1) if s < r]))
    return out


@pytest.mark.parametrize("cols,r", [
    *((128, r) for r in (25, 33, 65, 127, 193, 385, 1024)),  # the one-block design, 12 outputs a thread
    *((32, r) for r in (5, 17, 24, 25, 32, 33, 48, 49, 64, 63)),  # long rows, n2 = 8·r ≤ 512
    *((16, r) for r in (17, 25, 65, 96, 97, 127, 128)),           # long rows, 16-column tiles
])
def test_streamed_step_b_map_covers_each_output_once(cols, r):
    """Step B's output maps: every (column block, column, s) exactly once.
    The one-block design's ``step_b_stream`` (128 columns): lane → column
    p0 + lane mod LANES, owner → outputs s = s0 + owner + OWNERS·i in
    passes of OWNERS·12, one pass where it runs in place (r ≤ 192). The
    long design's ``step_b_tile`` (32 or 16 columns): the column blocks
    in two rounds of four, a lane two columns and at most 8 outputs of
    each a round, so each round runs in place in one pass for every r ≤
    128 (n2 ≤ 1024)."""
    if cols < 128:
        seen = np.zeros((8, cols, r), np.int64)
        for k, ps, outs in tile_step_b_outputs(cols, r):
            assert len(outs) <= 8
            for s in outs:
                seen[k, ps, s] += 1
        np.testing.assert_array_equal(seen, 1)
        return
    lanes, owners, sj = 32, WARPS, STREAM_MAX_SJ
    seen = np.zeros((cols, r), np.int64)
    passes = 0
    for s0 in range(0, r, owners * sj):
        passes += 1
        for t in range(512):
            lane, warp = t % 32, t // 32
            owner = warp * (32 // lanes) + lane // lanes
            for p0 in range(0, cols, lanes):
                p = p0 + lane % lanes
                for i in range(sj):
                    s = s0 + owner + owners * i
                    if s < r:
                        seen[p, s] += 1
    np.testing.assert_array_equal(seen, 1)
    if r <= 192:
        assert passes == 1


@pytest.mark.parametrize("n", [34816, 69632, 131072])
def test_n1_256_tables_hold_the_128_point_table_bit_for_bit(n):
    """The column pass reads step A's W_128^e as W_256^(2e) from the n1 =
    256 table: the same float32 values, so step A rounds as in the
    one-block design."""
    t = ct_plan.radix_tables(n)
    assert t.n1 == 256 and t.w1.shape == (128, 2)
    np.testing.assert_array_equal(t.w1[::2], ct_plan.radix_tables(17408).w1)


@pytest.mark.parametrize("n,n1", [(52_224, 384), (87_040, 640), (121_856, 896)])
def test_mixed_tables_hold_the_128_point_table_bit_for_bit(n, n1):
    """n1 = 384, 640, 896: the column pass reads W_128^e as W_n1^(e·n1/128),
    the same float32 values as the one-block design's table."""
    t = ct_plan.radix_tables(n)
    assert t.n1 == n1 and t.w1.shape == (n1 // 2, 2) and (t.a, t.n2 % 8) == (8, 0)
    np.testing.assert_array_equal(t.w1[:: n1 // 128], ct_plan.radix_tables(17408).w1)


# -- K4's long design ----------------------------------------------------


def halo_columns(c0: int, n1: int):
    """The columns whose bins form the halos of the tile starting at c0:
    ``(left, right)``, circular (``detect_ct.cu``)."""
    return (n1 - 1 if c0 == 0 else c0 - 1), (0 if c0 + TILE == n1 else c0 + TILE)


def k4_long_replica(fr: np.ndarray, fi: np.ndarray, plan: ct_plan.DetectPlan, halos=halo_columns):
    """K4's two phases on float32 CT-order spectra ``[rows, n]``:
    ``(seg_score, seg_arg, noise_floor_db, row_max)``."""
    rows, n = fr.shape
    n1, n2, rad, seg = plan.n1, plan.n2, plan.radius, ct_plan.SEGMENT
    pr = fr * fr + fi * fi  # float32, the kernels' power
    row_max = pr.max(axis=-1)
    # phase a: sub[(k2/8)·n1 + k1] for the CT rows k2 = 0 mod 8, in dB as the
    # detect body computes it, then the bisection
    m = np.arange(n)
    k2, k1 = m // n1, m % n1
    take = k2 % seg == 0
    sub = np.empty((rows, n // seg), np.float32)
    db = (10.0 * torch.log10(torch.from_numpy(pr[:, take]) + 1e-24) + plan.power_offset_db).numpy()
    sub[:, (k2[take] // seg) * n1 + k1[take]] = db
    lo, hi = sub.min(axis=-1), sub.max(axis=-1)
    for _ in range(plan.bisect_iters):
        mid = np.float32(0.5) * (lo + hi)
        below = 2 * (sub <= mid[:, None]).sum(axis=-1) < sub.shape[-1]
        lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
    nf = np.float32(0.5) * (lo + hi)
    conf = None
    if plan.conf_cs is not None:
        conf = torch.exp((torch.from_numpy(nf) - plan.power_offset_db + plan.conf_cs) * ct_plan.LN10_OVER_10).numpy()
    # phase b: tiles of TILE columns in natural order with the halos
    score = np.full((rows, n // seg), np.nan, np.float32)
    arg = np.full((rows, n // seg), np.nan, np.float32)
    u = np.arange(TILE * n2)
    tk2, tc = u // TILE, u % TILE  # the load: consecutive threads, consecutive columns
    h = np.arange(2 * rad)
    for c0 in range(0, n1, TILE):
        nat = np.full((rows, TILE * n2 + 2 * rad), np.nan, np.float32)
        nat[:, rad + tc * n2 + tk2] = pr[:, tk2 * n1 + c0 + tc]
        left, right = halos(c0, n1)
        before = h < rad
        hk2 = np.where(before, n2 - rad + h, h - rad)
        nat[:, np.where(before, h, TILE * n2 + h)] = pr[:, hk2 * n1 + np.where(before, left, right)]
        assert not np.isnan(nat).any()
        win = np.lib.stride_tricks.sliding_window_view(nat, 2 * rad + 1, axis=-1).max(axis=-1)
        p = nat[:, rad:rad + TILE * n2]
        c, kk2 = u // n2, u % n2
        k = kk2 + n2 * (c0 + c)
        pe = p + np.float32(1e-24)
        cand = (p >= win) & (pe > np.float32(plan.thr_lin)) & (k >= plan.keep_lo) & (k <= plan.keep_hi)
        if conf is not None:
            cand &= pe >= conf[:, None]
        tile_score = np.where(cand, p, np.float32(-np.inf)).astype(np.float32)
        g = np.arange(TILE * (n2 // seg))
        b2, gc = g // TILE, g % TILE
        v = tile_score[:, (gc * n2 + seg * b2)[:, None] + np.arange(seg)[None, :]]  # [rows, g, 8]
        best = v.max(axis=-1)
        first = np.where(v >= best[..., None], np.arange(seg), seg).min(axis=-1)
        f = b2 * n1 + c0 + gc
        score[:, f] = best
        arg[:, f] = first
    assert not (np.isnan(score).any() or np.isnan(arg).any())
    return score, arg, nf, row_max


def _planted_spectra(plan, seed):
    """Float32 CT-order spectra, 3 rows of noise with peaks planted where
    only a right tiling finds the right partials: row 0 holds, at every
    tile start c0, a bin exactly ``radius`` natural bins after a larger one
    in column c0 − 1 (the left halo; circular at c0 = 0); row 1, at every
    tile end, a bin exactly ``radius`` bins before a larger one in the next
    tile's first column (the right halo; circular at n1 − 1); row 2,
    single peaks at the first and last bins of every tile (k1 = 0 and
    n1 − 1 among them)."""
    n1, n2, rad = plan.n1, plan.n2, plan.radius
    rng = np.random.default_rng(seed)
    fr = rng.normal(size=(3, n1 * n2)).astype(np.float32)
    fi = rng.normal(size=(3, n1 * n2)).astype(np.float32)

    def plant(row, k1, k2, amp):
        fr[row, k2 * n1 + k1 % n1] = np.float32(amp)

    for c0 in range(0, n1, TILE):
        plant(0, c0 - 1, n2 - rad, 80.0)
        plant(0, c0, 0, 45.0)
        plant(1, c0 + TILE - 1, n2 - 1, 55.0)
        plant(1, c0 + TILE, rad - 1, 85.0)
        plant(2, c0, 0, 60.0)
        plant(2, c0 + TILE - 1, n2 - 1, 50.0)
    return fr, fi


NO_NOTCH = {"dc_notch_hz": None}  # the wrap's bins, k = 0 and n − 1, are candidates too


@pytest.mark.parametrize("n,radius,notch", [
    (2048, 10, True),    # 128·16
    (2048, 16, True),    # radius = n2: the whole neighbour column is the halo
    (2048, 16, False),   # and the wrap at k1 = 0 and n1 − 1 outside any notch
    (5120, 40, False),   # 128·40, radius = n2
    (17408, 10, True),   # the flagship
    (33792, 10, True),   # block_len 32768
    (34816, 10, True),   # n1 = 256
    (34816, 136, False), # n1 = 256, radius = n2
])
def test_long_k4_replica_equals_plain_detect(n, radius, notch):
    plan = ct_plan.detect_plan(n, **{**DET, "min_distance_bins": radius, **({} if notch else NO_NOTCH)})
    fr, fi = _planted_spectra(plan, n + radius)
    ours = k4_long_replica(fr, fi, plan)
    ref = fft_detect.detect_plain(torch.from_numpy(fr), torch.from_numpy(fi), plan)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, r.numpy())
    n1, n2 = plan.n1, plan.n2
    # the planted tile-edge peaks of row 2 are candidates; row 0's and 1's
    # smaller bins lose to the larger ones across the tile edge
    seg_of = lambda k1, k2: (k2 // 8) * n1 + k1
    for c0 in range(0, n1, TILE):
        if plan.keep_lo <= n2 * c0 <= plan.keep_hi:  # outside the DC notch
            assert np.isfinite(ours[0][2, seg_of(c0, 0)]) and ours[1][2, seg_of(c0, 0)] == 0
        assert ours[0][0, seg_of(c0, 0)] < 45.0**2 and ours[0][1, seg_of(c0 + TILE - 1, n2 - 1)] < 55.0**2


@pytest.mark.parametrize("mutant", ["no wrap", "swapped", "own column"])
def test_long_k4_replica_with_a_wrong_halo_disagrees(mutant):
    """The planted spectra see the halos: a replica that takes its halo
    from the wrong column gives other partials than the plain detect."""
    plan = ct_plan.detect_plan(2048, **{**DET, "min_distance_bins": 16, **NO_NOTCH})
    n1 = plan.n1
    halos = {
        "no wrap": lambda c0, n1: (max(c0 - 1, 0), min(c0 + TILE, n1 - 1)),
        "swapped": lambda c0, n1: halo_columns(c0, n1)[::-1],
        "own column": lambda c0, n1: (c0, c0 + TILE - 1),
    }[mutant]
    fr, fi = _planted_spectra(plan, 7)
    bad = k4_long_replica(fr, fi, plan, halos)
    ref = fft_detect.detect_plain(torch.from_numpy(fr), torch.from_numpy(fi), plan)
    assert not np.array_equal(bad[0], ref[0].numpy())
    assert n1 % TILE == 0


# -- routing walk ----------------------------------------------------------

PLANNED = sorted({ct_plan.plan_nfft(m) for m in range(1024, 131_073, 1024)})
# the 23 planned lengths whose split has n1 ∈ {384, 640, 896}: the mixed-radix warp FFT's
MIXED_SET = [
    52_224, 58_368, 64_512, 70_656, 76_800, 82_944, 87_040, 89_088, 95_232, 97_280, 101_376, 104_448,
    107_520, 110_592, 113_664, 116_736, 117_760, 119_808, 121_856, 122_880, 125_952, 128_000, 129_024,
]
MAX_LAGS = (600, 2048)


def test_planned_lengths_split_as_the_routing_walk_expects():
    assert len(PLANNED) == 128
    by_n1 = {}
    for n in PLANNED:
        by_n1.setdefault(ct_plan.ct_split(n)[0], []).append(n)
    assert {k: len(v) for k, v in by_n1.items()} == {128: 62, 256: 43, 384: 18, 640: 4, 896: 1}
    assert len(MIXED_SET) == 23 and sorted(by_n1[384] + by_n1[640] + by_n1[896]) == MIXED_SET
    assert min(MIXED_SET) == 52_224 and all(ct_plan.ct_split(n)[0] in (128, 256) for n in PLANNED if n <= 51_200)
    assert set(by_n1) == set(ct_plan.RADIX_N1)


def _route_kernels(n: int, *, mega: bool, fft_detect_on: bool, detect_on: bool):
    """The kernels ``TDOAPipeline.step_split`` sends rows of n to under the
    route knobs, from the port's own predicates: ``[(name, check)]``, each
    check the kernel's pure length test."""
    routing = dict(min_distance_bins=10, noise_floor_stride=8)
    detect.set_fused_detect("auto" if detect_on else "off")
    detect.set_fused_fft_detect("auto" if fft_detect_on else "off")
    channel_step.set_mega_fused("on" if mega else "off")
    try:
        assert sc.gcc_fused_enabled(n, "phat")
        fused = detect.fused_detect_enabled(n, **routing)
        combined = fused and detect.fused_fft_detect_enabled(n, **routing)
        pair = [(f"K2@{lag}", lambda lag=lag: gcc_pair._geometry(n, lag, "K2")) for lag in MAX_LAGS]
        if combined and channel_step.supported(n, 8, weighting="phat", **routing):
            return [("K8", lambda: channel_step.geometry(n))]
        if combined:
            return [("K1", lambda: fft_detect.geometry(n))] + pair
        forward = [("K3", lambda: fft_rows.geometry(n))]
        if fused:
            forward.append(("K4", lambda: detect_ct.geometry(n, routing["min_distance_bins"])))
        return forward + pair
    finally:
        detect.set_fused_detect("auto")
        detect.set_fused_fft_detect("auto")
        channel_step.set_mega_fused("off")


ROUTE_KNOBS = {
    "default": dict(mega=False, fft_detect_on=True, detect_on=True),
    "two-kernel": dict(mega=False, fft_detect_on=False, detect_on=True),
    "unfused-detect": dict(mega=False, fft_detect_on=True, detect_on=False),
    "mega": dict(mega=True, fft_detect_on=True, detect_on=True),
}


@pytest.mark.parametrize("route", sorted(ROUTE_KNOBS))
def test_every_planned_length_has_a_kernel_on_each_route_but_f3b(route):
    """Every planned nfft up to 131072 (block_len ≤ 65536 at any max_lag <
    block_len) is taken by each kernel its route sends it to: the F3b set
    of lengths no design takes is empty. K1 takes its one-launch cluster
    designs at every length (the cluster design at n1 = 128, 256, the wide
    one at 384, 640, 896); K3 one block a row up to 24576 and the long
    design above, K8 its cluster design and its long one (the long K1,
    then K2); the long rows of K3 take the cluster design at n1 = 128, 256
    and the wide one at 384, 640, 896."""
    seen = set()
    designs = {}
    long_designs = {}
    for n in PLANNED:
        n1 = ct_plan.ct_split(n)[0]
        for name, check in _route_kernels(n, **ROUTE_KNOBS[route]):
            seen.add(name)
            design = check()
            if isinstance(design, str):
                designs.setdefault(name, set()).add((design, n > fft_detect.MAX_N))
                if name == "K1":
                    assert design == {128: "cluster", 256: "cluster"}.get(n1, "wide"), (name, n)
                elif design == "long":
                    got = fft_rows.long_geometry(n).design
                    assert got == {128: "cluster", 256: "cluster"}.get(n1, "wide"), (name, n)
                    long_designs.setdefault(name, set()).add(got)
    want = {"default": {"K1"}, "two-kernel": {"K3", "K4"}, "unfused-detect": {"K3"}, "mega": {"K8"}}[route]
    assert want <= seen
    allowed = {
        "K1": {("cluster", False), ("cluster", True), ("wide", True)},
        "K3": {("block", False), ("long", True)},
        "K8": {("cluster", False), ("long", True)},
    }
    for name, got in designs.items():
        assert got <= allowed[name], (name, got)
        if name in want:
            assert got == allowed[name], (name, got)
            if name != "K1":
                assert long_designs[name] == {"cluster", "wide"}, (name, long_designs[name])


def test_wideband_k3_and_pair_stage_take_every_planned_length_but_f3b():
    """The wideband path's K3 and K5/K6 (``gcc_pair._geometry``) at every
    planned nfft, with the inner length of the split."""
    for n in PLANNED:
        n1 = ct_plan.ct_split(n)[0]
        assert fft_rows.geometry(n) in ("block", "long")
        for lag in MAX_LAGS:
            assert gcc_pair._geometry(n, lag, "K5")[0] == n1


def test_design_choice_by_length():
    """K3: one block a row up to 24576, the long design above: the cluster
    design at n1 = 128 and 256, the wide design (K1's kernel without its
    detect half) at 384, 640 and 896. K1 (the flagship's radius, 10): one
    launch at every length whose n2 holds the radius, the cluster design
    (K3's cluster kernel with its detect half) at n1 = 128 and 256 and the
    wide design at 384, 640 and 896, with ``emit_topk`` as without (its
    top-K in the same launch). K4 has
    one design, whose shared memory (n/8 floats, or a 16-column tile) fits
    at every planned length the fused detect takes, at any radius up to
    n2."""
    for n in PLANNED:
        n1, n2 = ct_plan.ct_split(n)
        if detect_ct.supported(n, min_distance_bins=10, noise_floor_stride=8):
            assert 0 < detect_ct.geometry(n, 10) <= detect_ct.geometry(n, n2) <= fft_detect.SMEM_LIMIT, n
        else:
            assert n2 < 10, n
        want = "block" if n <= fft_rows.MAX_N else "long"
        one = {128: "cluster", 256: "cluster"}.get(n1, "wide") if n2 >= 10 else want
        assert fft_rows.geometry(n) == want and fft_detect.geometry(n, emit_topk=8) == one, n
        assert fft_detect.geometry(n) == one, n
        assert channel_step.geometry(n) == ("cluster" if want == "block" else "long"), n
        if want == "long":
            design = {128: "cluster", 256: "cluster"}.get(n1, "wide")
            assert fft_rows.long_geometry(n).design == design, n
    with pytest.raises(ValueError, match="radius"):
        detect_ct.geometry(17408, 137)  # radius > n2 = 136


# the instantiations fft_rows_ct_cluster.cu builds: (n1, columns a tile),
# for K3 (detect half off) and for K1 (on)
BUILT_CLUSTER_VARIANTS = {(128, 32), (128, 16), (256, 32)}
BUILT_CLUSTER_DETECT_VARIANTS = {(128, 32), (128, 16), (256, 32)}
# fft_detect_cluster.cuh (the wide design): its n1
BUILT_WIDE = {384, 640, 896}
# fft_rows_ct_long.cu (the workspace design, the wide design's comparison
# only): its row passes and column-pass variants (step B's registers RMAX
# or 0 if streamed, outputs a thread SJ)
BUILT_WORKSPACE_ROWS = {384, 640, 896}
BUILT_WORKSPACE_COLUMNS = {(24, 0), (0, 2), (0, 3)}


def test_long_k3_builds_only_the_variants_planned_lengths_reach():
    """Every planned length the long K3 takes (and the lengths the card
    tests force onto it: 17408, 24576) splits with a = 8 into a built
    kernel variant, and together they reach every built one: the cluster
    design at n1 = 128 and 256 (and its K1 instantiations at every planned
    length K1's cluster design takes), the wide design at 384, 640 and 896, and
    there the workspace design as the wide design's comparison
    (``fft_rows.workspace_rows``, no route; 32-column tiles, step B in
    registers up to r = 24, else streamed with the fewest outputs a thread
    that cover r in one pass); a long split with 8 ∤ n2 raises before any
    launch."""
    cluster, wide, rows, columns = set(), set(), set(), set()
    for n in [17408, 24576] + [n for n in PLANNED if n > fft_rows.MAX_N]:
        g = fft_rows.long_geometry(n)
        assert g.a == 8 and g.n2 <= 1024, n
        if g.design == "cluster":
            assert g.n1 in (128, 256), n
            cluster.add((g.n1, g.cols))
            continue
        assert g.design == "wide" and g.n1 in (384, 640, 896) and g.c == 8 and g.cols == g.n1 // 8, n
        wide.add(g.n1)
        assert g.n2 <= 512, n  # the workspace design takes every such length, as the comparison
        rows.add(g.n1)
        columns.add((24, 0) if g.r <= 24 else (0, next(sj for sj in (2, 3, 4) if g.r <= sj * WARPS)))
    assert cluster == BUILT_CLUSTER_VARIANTS and wide == BUILT_WIDE
    # K1's cluster design at every planned n1 = 128/256 length it takes (its own c: the power buffer in the fit)
    detect = {(g.n1, g.cols) for g in (fft_detect.cluster_geometry(n) for n in PLANNED
                                       if fft_detect.one_pass_design(n) == "cluster")}
    assert detect == BUILT_CLUSTER_DETECT_VARIANTS
    assert rows == BUILT_WORKSPACE_ROWS and columns == BUILT_WORKSPACE_COLUMNS
    assert ct_plan.ct_split(25_728) == (128, 201)
    with pytest.raises(ValueError, match="multiple of 8"):
        fft_rows.geometry(25_728)
