"""Kernel K1: forward CT-order FFT + spectral detection in one pass per row.

Replaces ``radio_mapper_tpu/ops/pallas/detect_kernel.py::fft_detect_rows_ct``
(body ``fft_kernel.ct_fft_core`` + ``detect_kernel._detect_body``).

Its designs, chosen by length, ``emit_topk`` and detect radius inside
:func:`fft_detect_rows_ct` (:func:`geometry`); a length none takes raises
``ValueError``. Every call is one launch of K1 (:data:`launch_count`,
:data:`design_counts` by design):

- ``"cluster"``, n1 = 128 or 256 at every length with 2 ≤ radius ≤ n2,
  with or without ``emit_topk`` (the default route's K1 from nfft 2048
  up: the flagship's 17408, 33792, 34816, 66560; :func:`cluster_detect`,
  :func:`cluster_geometry`): the long-row K3's cluster kernel
  (``csrc/fft_rows_ct_cluster.cu``) with its detect half on. A row is a
  thread-block cluster of c = 2, 4 or 8 blocks; each transforms n1/c
  columns (steps A, B), then its n2/c slot rows through distributed
  shared memory (step C), storing the spectra and keeping their power;
  block 0's first r slot rows are the stride-8 subsample, so it finds the
  noise floor alone (one order statistic, ``csrc/ct_detect.cuh``
  ``floor_select``) and hands it to the others, then detects its share of
  the columns (:data:`BLOCK0_SHARE`); the others pull their columns' power
  in natural order and run the sliding max, the gates and the segment
  partials (``ct_detect.cuh`` ``pull_natural``, ``window_partials``,
  ``gate_partials``: the wide design's code). One pass through device
  memory, 16 B a sample; the outputs equal the one-block K1's and the
  cluster K3 → K4's bit for bit. With ``emit_topk = K`` (1..128, the
  reference's in-kernel top-K, T1) an instantiation of its own has each
  block take its first K staged segments in (score descending, segment f
  ascending) order before the floor arrives (``ct_detect.cuh``
  ``topk_block8`` for K ≤ 8, the flagship's: the K-th largest of the
  warps' largest scores bounds the block's K-th from below, and one warp
  ranks the dozen or so segments at or above it; ``topk_block`` above:
  warp passes and a rank merge). The block holding column 0 merges the c
  lists: for K ≤ 8 every block stores its list over distributed shared
  memory into an inbox at the end of the merger's column buffer before
  the floor's cluster barrier, which is then the kernel's last
  (``topk_merge8``); above, the merger pulls the lists after it and one
  more barrier follows (``topk_merge``). It gates them (the confidence
  gate is monotone in the score, so a list's passing entries are its
  first), merges them and writes the row's ``[128]`` block (lanes past
  the row's candidates take segment 0's gated offset, as the reference's
  passes do): no F/8 partials reach device memory (:func:`topk_fits`).
- ``"wide"``, n1 = 384, 640, 896 (``csrc/fft_detect_cluster.cuh``, a
  template on n1; :func:`wide_detect`): the same structure on a cluster of
  8 blocks, block 0 finding the floor while blocks 1 .. 7 detect; with
  ``emit_topk`` block 1 merges.
- ``"block"``, n ≤ :data:`MAX_N` with a radius outside 2 .. n2 (or a
  length no cluster design takes): one 512-thread block per row keeps the whole row (re+im,
  139,264 B at nfft 17408) in shared memory and runs kernel K3's radix
  steps on it (``csrc/fft_detect.cu``, ``csrc/ct_fft.cuh``
  ``fft_power_row``), hands each value's power to ``ct_detect.cuh``'s
  ``detect_row`` (the 24-step bisection floor, the sliding max, the gates,
  the segment partials) and, with ``emit_topk = K`` (1..128, the
  reference's in-kernel top-K), K block-wide masked-argmax passes over
  the partials (``block_topk``) write a [rows, 128] block of values and
  packed 8·f + offset in place of the F/8 partials (:func:`block_detect`;
  the card tests' comparison for the cluster design up to 24576, with and
  without ``emit_topk``).
- ``"long"``, above :data:`MAX_N` with a radius outside 2 .. n2: the
  long-row K3 (``fft_rows.long_rows``) and then K4
  (``csrc/detect_ct.cu``, which holds no row in shared memory, with the
  row max and its top-K phase) on its spectra; the reference's function
  is that composition, so the outputs are K3 → K4's bit for bit (the card
  tests' comparison for the cluster designs above 24576).

What bounds it on the H100: device-memory bytes (the row read and the
spectra written once, ≈ 0.28 MB a row at 17408) and then the radix steps'
barriers and DSMEM traffic, step B's direct r-point DFT (r = 17 ... 127),
and the floor on block 0 with the others' detect. Left for later PRs:
TMA row loads, tensor cores, and fusing K1 into the pair stage (K2) so
the spectra never reach device memory.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from radio_mapper_tpu_torch import constants, device
from radio_mapper_tpu_torch.ops import ct_plan, safe
from radio_mapper_tpu_torch.ops.cuda import build, detect_ct, fft_rows
from radio_mapper_tpu_torch.utils import spans

launch_count = 0  # launches of K1 (not of the plain version); a long-row call counts once
design_counts = {"block": 0, "cluster": 0, "long": 0, "wide": 0}  # the same launches, by design ("long": K3 → K4)
DEFAULT_RADIUS = constants.DEFAULT_PEAK_MIN_DISTANCE_BINS  # the detect radius geometry() assumes
# block 0's share of the detect columns by cluster size: its floor and its share end with the
# others' shares (timed on the card over the shares at 17408, 33792, 34816; PERF.md)
BLOCK0_SHARE = {2: 3 / 8, 4: 1 / 8, 8: 0.0}
FLOOR_NB = 1024  # its histogram's buckets (rm_det::FLOOR_NB)

THREADS = 512  # must match K1_THREADS in fft_detect.cu (= ct_fft.cuh's THREADS)
MAX_N = 24_576  # the one-block design's limit: power held in registers, n2 ≤ (THREADS/32)·HANDOFF_MAX_HELD/4 = 192
SMEM_LIMIT = 232_448 - 256  # H100 per-block shared memory less the static part
W128_BYTES = 64 * 8  # W_128^e, e < 64, after the row in shared memory

_ARGTYPES = (
    [ctypes.c_void_p] * 12
    + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    + [ctypes.c_int, ctypes.c_void_p]
)
TOPK_LANES = 128  # the emit_topk output block, [rows, 128] (rm_det::TOPK_LANES)
_CLUSTER_ARGTYPES = (
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p]
)
_CLUSTER_INFO_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] * 5
TOPK_WARPS = THREADS // 32  # the warps of a cluster block's top-K (rm_det::topk_block)
TOPK_PER_LANE = 8  # a lane's staged segments in its registers there (rm_det::TOPK_PER_LANE)
TOPK_FAST = 8  # K up to this takes topk_block8 and the merger's inbox (rm_det::TOPK_FAST; the flagship's max_peaks)
TOPK_INBOX = 8 * 32  # the inbox's floats at the end of each block's column buffer (rm_det::TOPK_INBOX)


def check_topk(emit_topk: int) -> None:
    """``emit_topk`` in 0 (off) or 1..128, as the reference checks it
    (``detect_kernel._detect_plan``)."""
    if not 0 <= emit_topk <= TOPK_LANES:
        raise ValueError(f"emit_topk must be in 1..{TOPK_LANES} (one lane block), or 0; got {emit_topk}")


def check_rows(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan) -> None:
    """float32, contiguous ``[rows ≥ 1, plan.nfft]`` re/im on one device
    (the input contract of kernels K1 and K4)."""
    if re.shape != im.shape or re.dim() != 2 or re.shape[0] < 1:
        raise ValueError(f"need re/im of one shape [rows ≥ 1, nfft], got {tuple(re.shape)}, {tuple(im.shape)}")
    if re.shape[-1] != plan.nfft:
        raise ValueError(f"rows of length {re.shape[-1]} but the plan is for nfft {plan.nfft}")
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise TypeError(f"need float32, got {re.dtype}, {im.dtype}")
    if re.device != im.device:
        raise ValueError(f"re on {re.device}, im on {im.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("re/im must be contiguous")


def plan_args(plan: ct_plan.DetectPlan) -> list:
    """The detection parameters as the C entries of K1, K4 and K8 take
    them (``rm_det::DetectParams``)."""
    return [
        plan.radius, plan.keep_lo, plan.keep_hi,
        plan.thr_lin, int(plan.conf_cs is not None),
        0.0 if plan.conf_cs is None else plan.conf_cs,
        plan.power_offset_db, plan.bisect_iters,
    ]


def radix_geometry(n: int, kernel: str = "K1"):
    """``(n2, a, r)`` of a row the one-block design of K1's forward half
    takes (K8's too): n = 128·n2, n2 = 8·r, n ≤ :data:`MAX_N`, the row and
    W_128 in shared memory. Raises ValueError otherwise."""
    n2, a, r = ct_plan.radix_split(n)  # raises unless n = 128·n2
    if a != ct_plan.RADIX_MAX_A or n > MAX_N or n * 8 + W128_BYTES > SMEM_LIMIT:
        raise ValueError(
            f"{kernel} supports nfft = 128·n2 with 8 | n2 and nfft ≤ {MAX_N} (one row and W_128 "
            f"in shared memory); got nfft {n} = 128·{n2}"
        )
    return n2, a, r


class ClusterGeometry(NamedTuple):
    """K1's cluster design at one length (:func:`cluster_geometry`)."""

    n1: int
    n2: int
    a: int  # step A's length, 8
    r: int  # step B's length, n2 / 8
    c: int  # blocks a row
    cols: int  # columns a tile of steps A and B
    dcols0: int  # block 0's detect columns (it finds the floor first)
    smem: int  # dynamic shared memory a block


def cluster_columns(n1: int, c: int) -> int:
    """Block 0's detect columns in a cluster of c (it finds the floor over
    the n/8 subsample values first, then detects them): the share
    :data:`BLOCK0_SHARE` of n1 in quads, the rest over the other blocks
    (:func:`detect_columns`)."""
    return 4 * round(n1 * BLOCK0_SHARE[c] / 4)


def detect_columns(rank: int, n1: int, c: int, dcols0: int):
    """The detect columns ``(d0, dn)`` of block ``rank``: ``dcols0`` on
    block 0, the rest over blocks 1 .. c−1 in quads as evenly as they go,
    the first blocks a quad more (``fft_rows_ct_cluster.cu``
    ``detect_columns``)."""
    if rank == 0:
        return 0, dcols0
    quads, b = (n1 - dcols0) // 4, rank - 1
    per, extra = divmod(quads, c - 1)
    return dcols0 + 4 * (b * per + min(b, extra)), 4 * (per + (b < extra))


@functools.lru_cache(maxsize=64)
def cluster_geometry(n: int, radius: int = DEFAULT_RADIUS) -> ClusterGeometry:
    """K1's cluster design (``csrc/fft_rows_ct_cluster.cu`` with its
    detect half) for rows of n = n1·n2 samples, n1 = 128 or 256, 8 | n2,
    decided without a card: c from :func:`fft_rows.cluster_size` with the
    power buffer (two blocks an SM where they fit), the column tile of the
    long K3 at that c, block 0's detect columns; the detect half's shared
    memory (block 0's dB values, histogram and bucket; every block's
    natural-order columns with ``radius`` halo bins, the windows' overrun
    and the staged partials) fits the freed column buffer, 2·n/c floats.
    Raises ValueError otherwise (and for radius outside 2 .. n2). Cached:
    the wrapper asks at every call."""
    n1, n2 = ct_plan.ct_split(n)
    _, a, r = ct_plan.radix_split(n)
    if n1 not in fft_rows.CLUSTER_N1 or a != ct_plan.RADIX_MAX_A or not 2 <= radius <= n2:
        raise ValueError(f"K1's cluster design takes n1 in {fft_rows.CLUSTER_N1}, 8 | n2 and 2 ≤ radius ≤ n2; "
                         f"nfft {n} = {n1}·{n2}, radius {radius}")
    c = fft_rows.cluster_size(n1, n2, detect=True)
    cols = 32 if n2 <= 512 and (n1 // c) % 32 == 0 else 16
    dcols0 = cluster_columns(n1, c)
    buf = 2 * (n1 // c) * n2  # floats
    dn = max(n for _, n in (detect_columns(k, n1, c, dcols0) for k in range(c)))
    if r * n1 + FLOOR_NB + THREADS > buf or dn * n2 + 2 * radius + 4 + 2 * r * dn > buf:
        raise ValueError(f"K1's cluster design at nfft {n} = {n1}·{n2}, c = {c}: the detect half does not fit "
                         f"{4 * buf} B")
    return ClusterGeometry(n1, n2, a, r, c, cols, dcols0, fft_rows.cluster_smem(n1, n2, c, detect=True))


def wide_columns(rank: int, n1: int):
    """The wide design's detect columns ``(d0, dn)`` of block ``rank``:
    none on block 0, 4·⌈n1/28⌉ (56, 92, 128) on blocks 1 .. 6, the rest on
    block 7 (``fft_detect_cluster.cuh``)."""
    d = 4 * -(-n1 // 28)
    if rank == 0:
        return 0, 0
    return d * (rank - 1), (d if rank < fft_rows.WIDE_C - 1 else n1 - d * (fft_rows.WIDE_C - 2))


def topk_block_floats(k: int, staged: int) -> int:
    """Floats of the top-K scratch a cluster block with ``staged`` = r·dn
    segments uses before the merge (``rm_det::topk_block_floats``): its
    list (3k), its length, segment 0's score and offset, the warps'
    lengths, then the warps' lists: for k ≤ :data:`TOPK_FAST` their 8
    keys (two words each), else min(k, ⌈staged/16⌉) scores and indices."""
    per = TOPK_FAST if k <= TOPK_FAST else min(k, -(-staged // TOPK_WARPS))
    return 3 * k + 3 + TOPK_WARPS + 2 * TOPK_WARPS * per


def topk_stage_floats(k: int, c: int) -> int:
    """Floats the merger's staged c lists reach (``rm_det::topk_stage_floats``)."""
    return 3 * k + 3 + TOPK_WARPS + 3 * c * k + c


def topk_fits(n: int, emit_topk: int, radius: int = DEFAULT_RADIUS) -> bool:
    """Whether the one-pass design at n holds the in-kernel top-K of K =
    ``emit_topk`` in its freed column buffer (``topk_fits`` of
    ``fft_rows_ct_cluster.cu`` and ``fft_detect_cluster.cuh``): every
    block's list and its warps' lists before its staged partials (after
    its natural-order columns, halos and the windows' overrun), its r·dn
    staged segments in its lanes' registers (:data:`TOPK_PER_LANE` a
    lane), the merger's inbox (:data:`TOPK_INBOX` floats) at the buffer's
    end past block 0's floor scratch and every block's columns and staged
    partials, and the merger's c lists within the buffer (2·n/c floats;
    the wide design's n/4). A length neither design takes does not fit."""
    check_topk(emit_topk)
    try:
        g = fft_rows.long_geometry(n)
    except ValueError:
        return False
    n1, n2, r = g.n1, g.n2, g.r
    if g.design == "wide":
        c, buf, cols = fft_rows.WIDE_C, n // 4, [wide_columns(k, n1) for k in range(fft_rows.WIDE_C)]
    else:
        try:
            cg = cluster_geometry(n, radius)
        except ValueError:
            return False
        c, buf = cg.c, 2 * (n1 // cg.c) * n2
        cols = [detect_columns(k, n1, c, cg.dcols0) for k in range(c)]
    floor_fits = r * n1 + FLOOR_NB + THREADS + TOPK_INBOX <= buf  # block 0's floor scratch, then the inbox
    return emit_topk >= 1 and floor_fits and topk_stage_floats(emit_topk, c) <= buf and all(
        topk_block_floats(emit_topk, r * dn) <= dn * n2 + 2 * radius + 4 and r * dn <= THREADS * TOPK_PER_LANE
        and dn * n2 + 2 * radius + 4 + 2 * r * dn + TOPK_INBOX <= buf for _, dn in cols if dn)


@functools.lru_cache(maxsize=256)
def one_pass_design(n: int, emit_topk: int = 0, radius: int = DEFAULT_RADIUS):
    """K1's one-launch cluster design for rows of n samples at any length,
    or None: ``"cluster"`` (n1 = 128, 256: :func:`cluster_geometry`) or
    ``"wide"`` (n1 = 384, 640, 896), with 2 ≤ radius ≤ n2; with
    ``emit_topk`` where its top-K scratch fits (:func:`topk_fits`: at every
    planned length, K in 1..128)."""
    try:
        g = fft_rows.long_geometry(n)
    except ValueError:
        return None
    if not 2 <= radius <= g.n2:
        return None
    design = "wide"
    if g.design != "wide":
        try:
            cluster_geometry(n, radius)
        except ValueError:
            return None
        design = "cluster"
    if emit_topk and not topk_fits(n, emit_topk, radius):
        return None
    return design


def geometry(n: int, emit_topk: int = 0, radius: int = DEFAULT_RADIUS) -> str:
    """K1's design for rows of n samples with this ``emit_topk`` and
    detect radius, decided without a card: the one-launch cluster designs
    where they take it (:func:`one_pass_design`, with or without
    ``emit_topk``; up to :data:`MAX_N` too, where the card ran it faster
    than the one-block design on 1024 rows at 9216, 17408, 20480 and
    24576, PERF.md), else ``"block"`` (n ≤ :data:`MAX_N`,
    :func:`radix_geometry`) or ``"long"`` (the long K3, then K4). Raises
    ValueError for a length no design takes."""
    if n <= MAX_N:
        radix_geometry(n)
        return one_pass_design(n, emit_topk, radius) or "block"
    one = one_pass_design(n, emit_topk, radius)
    if one is None:
        fft_rows.geometry(n)  # raises unless a long-row K3 design takes n
    return one or "long"


def fft_detect_rows_ct(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan, emit_topk: int = 0):
    """Forward CT-order FFT + fused detection of ``[rows, nfft]`` rows.

    Args:
      re/im: float32 ``[rows, nfft]`` time rows, already zero-padded.
      plan: :func:`ct_plan.detect_plan` for this nfft.
      emit_topk: 0, or K in 1..128 to finish the peak selection in the
        kernel (the reference's ``emit_topk``).
    Returns:
      ``(fr, fi, seg_score, seg_arg, noise_floor_db, row_max)``: CT-order
      spectra ``[rows, nfft]``; per-segment partials ``[rows, nfft/8]``
      (linear power, −inf where the segment holds no candidate; float
      in-segment offset 0-7 — segment f = b2·n1 + k1 covers natural bins
      (8·b2 + off) + n2·k1); the noise floor in dB and each row's max
      linear power, ``[rows]``. With ``emit_topk = K`` the partials are
      replaced by ``[rows, 128]`` blocks: lane k < K holds the k-th
      largest segment score and its packed ``8·f + off`` (as float, exact),
      lanes ≥ K are 0.

    CPU tensors go through :func:`fft_detect_rows_ct_plain`; CUDA tensors
    launch the design :func:`geometry` picks, counted as one launch of K1.
    """
    check_rows(re, im, plan)
    check_topk(emit_topk)
    if re.device.type == "cpu":
        with device.cpu_single_thread():
            return fft_detect_rows_ct_plain(re, im, plan, emit_topk)
    if re.device.type != "cuda":
        raise ValueError(f"no K1 implementation for device {re.device}")
    return _run(geometry(plan.nfft, emit_topk, plan.radius), re, im, plan, emit_topk)


def fft_detect_rows_ct_long(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan, emit_topk: int = 0):
    """:func:`fft_detect_rows_ct` through the long-row designs on CUDA rows
    of a length :func:`fft_rows.long_geometry` takes, counted as one launch
    of K1: the one-launch cluster design (:func:`one_pass_design`) where it
    takes the plan, else the long K3 and then K4 with the row max
    (``design_counts["long"]``). The card tests and ``chip_smoke.py`` also
    force rows up to :data:`MAX_N` through it."""
    check_rows(re, im, plan)
    check_topk(emit_topk)
    if re.device.type != "cuda":
        raise ValueError(f"the long-row K1 runs on CUDA tensors, not {re.device}")
    return _run(one_pass_design(plan.nfft, emit_topk, plan.radius) or "long", re, im, plan, emit_topk)


def _run(design: str, re, im, plan, emit_topk):
    """One launch of K1 through ``design`` (a launch the card refuses
    raises), counted in :data:`launch_count` and :data:`design_counts`,
    inside the program span ``fft_detect.k1`` (:mod:`..utils.spans`)."""
    global launch_count
    with spans.span("fft_detect.k1"):
        if design == "block":
            out = block_detect(re, im, plan, emit_topk)
        elif design == "cluster":
            out = cluster_detect(re, im, plan, emit_topk)
        elif design == "wide":
            out = wide_detect(re, im, plan, emit_topk)
        else:
            fr, fi = fft_rows.long_rows(re, im)
            out = (fr, fi, *detect_ct.launch(fr, fi, plan, row_max=True, emit_topk=emit_topk))
    launch_count += 1
    design_counts[design] += 1
    return out


def _outputs(rows: int, plan: ct_plan.DetectPlan, dev, emit_topk: int = 0):
    """The detect outputs of a launch: segment scores and offsets ``[rows,
    nfft/8]`` (with ``emit_topk`` the ``[rows, 128]`` top-K values and
    packed indices), floor and row max ``[rows]``."""
    s = TOPK_LANES if emit_topk else plan.segments
    shapes = ((rows, s), (rows, s), (rows,), (rows,))
    return tuple(torch.empty(shape, dtype=torch.float32, device=dev) for shape in shapes)


def _check_topk_fits(n: int, emit_topk: int, radius: int, design: str) -> None:
    check_topk(emit_topk)
    if emit_topk and not topk_fits(n, emit_topk, radius):
        raise ValueError(f"K1's {design} design at nfft {n}: the top-K of {emit_topk} does not fit")


def cluster_detect(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan, emit_topk: int = 0):
    """K1 through the cluster design (n1 = 128, 256: ``csrc/
    fft_rows_ct_cluster.cu`` with its detect half on, geometry
    :func:`cluster_geometry`) on contiguous float32 CUDA rows, uncounted:
    ``(fr, fi, seg_score, seg_arg, noise_floor_db, row_max)`` from one
    launch; with ``emit_topk = K`` its top-K instantiation, the partials
    replaced by ``[rows, 128]`` blocks. A launch the card refuses (no
    cluster of this shape fits) raises. Kernel K8's long design calls it
    too."""
    n = plan.nfft
    if re.shape[-1] != n:
        raise ValueError(f"the cluster K1 takes a plan for nfft {re.shape[-1]}, got {n}")
    g = cluster_geometry(n, plan.radius)
    _check_topk_fits(n, emit_topk, plan.radius, "cluster")
    dev, rows = re.device, re.numel() // n
    w1, wn2, _ = ct_plan.device_radix_tables(n, dev)
    tw = ct_plan.device_tables(n, False, dev).tw
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    det = _outputs(rows, plan, dev, emit_topk)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    fn = build.kernel("rm_fft_detect_cluster", _CLUSTER_ARGTYPES)
    err = fn(
        ptr(re), ptr(im), ptr(w1), ptr(wn2), ptr(fft_rows.device_step_b_roots(n, dev)), ptr(tw), ptr(fr), ptr(fi),
        *(ptr(x) for x in det), rows, g.n1, g.n2, g.a, g.r, g.c, g.dcols0, *plan_args(plan), emit_topk,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    build.check(err, "fft_detect_rows_ct (cluster)")
    return (fr, fi, *det)


def cluster_info(n: int, radius: int = DEFAULT_RADIUS, emit_topk: int = 0) -> dict:
    """K1's cluster design at n on the current card (with ``emit_topk``
    its top-K instantiation): ``c``, block 0's detect columns ``dcols0``,
    dynamic shared memory a block (``smem``), blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), active clusters
    (``cudaOccupancyMaxActiveClusters``; 0 would mean the card cannot run
    it), registers a thread and local memory in bytes."""
    g = cluster_geometry(n, radius)
    vals = [ctypes.c_int(0) for _ in range(5)]
    fn = build.kernel("rm_fft_detect_cluster_info", _CLUSTER_INFO_ARGTYPES)
    build.check(fn(g.n1, g.n2, g.a, g.r, g.c, emit_topk, *(ctypes.byref(v) for v in vals)), "cluster_info (K1)")
    smem, blocks, clusters, registers, local = (v.value for v in vals)
    return {"c": g.c, "dcols0": g.dcols0, "smem": smem, "blocks": blocks, "clusters": clusters,
            "registers": registers, "local_bytes": local}


def wide_detect(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan, emit_topk: int = 0):
    """K1 through the wide design (n1 = 384, 640, 896, ``csrc/fft_detect_cluster.cuh``
    with its detect half on) on contiguous float32 CUDA rows, uncounted:
    ``(fr, fi, seg_score, seg_arg, noise_floor_db, row_max)`` from one
    launch (:func:`fft_rows.wide_launch`); with ``emit_topk = K`` its
    top-K instantiation, the partials replaced by ``[rows, 128]`` blocks.
    Kernel K8's long design calls it too."""
    if plan.nfft != re.shape[-1] or plan.radius < 2:
        raise ValueError(
            f"the wide K1 takes a plan for nfft {re.shape[-1]} with radius ≥ 2, got {plan.nfft}, {plan.radius}"
        )
    _check_topk_fits(plan.nfft, emit_topk, plan.radius, "wide")
    det = _outputs(re.numel() // plan.nfft, plan, re.device, emit_topk)
    fr, fi = fft_rows.wide_launch(re, im, det, tuple(plan_args(plan)), topk=emit_topk)
    return (fr, fi, *det)


def block_detect(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan, emit_topk: int = 0):
    """K1 through the one-block design (``csrc/fft_detect.cu``, n ≤
    :data:`MAX_N`) on contiguous float32 CUDA rows, uncounted: the route
    for a radius outside 2 .. n2, and the card tests' and tools'
    comparison for the cluster design up to 24576, with and without
    ``emit_topk``."""
    n = plan.nfft
    n2, a, r = radix_geometry(n)
    fn = build.kernel("rm_fft_detect_rows_ct", _ARGTYPES)
    w128, wn2, wr = ct_plan.device_radix_tables(n, re.device)
    tw = ct_plan.device_tables(n, False, re.device).tw
    rows = re.shape[0]
    s = TOPK_LANES if emit_topk else plan.segments
    fr = torch.empty_like(re)
    fi = torch.empty_like(im)
    score = torch.empty((rows, s), dtype=torch.float32, device=re.device)
    arg = torch.empty((rows, s), dtype=torch.float32, device=re.device)
    nf = torch.empty((rows,), dtype=torch.float32, device=re.device)
    rmax = torch.empty((rows,), dtype=torch.float32, device=re.device)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = fn(
        ptr(re), ptr(im), ptr(w128), ptr(wn2), ptr(wr), ptr(tw),
        ptr(fr), ptr(fi), ptr(score), ptr(arg), ptr(nf), ptr(rmax),
        rows, n2, a, r, *plan_args(plan), emit_topk,
        ctypes.c_void_p(torch.cuda.current_stream(re.device).cuda_stream),
    )
    build.check(err, "fft_detect_rows_ct")
    return fr, fi, score, arg, nf, rmax


def fft_detect_rows_ct_plain(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan, emit_topk: int = 0):
    """Plain PyTorch version of K1: the same function as the four-step
    DFT on ``ct_constants``' tables, as batched tensor ops. Same contract as
    :func:`fft_detect_rows_ct`. On the card it is the comparison only,
    with ``torch.backends.cuda.matmul.allow_tf32 = False`` set by the
    caller (full FP32 products). Through its wrapper on the CPU it runs at one intra-op thread
    (:func:`device.cpu_single_thread`, fault F2)."""
    fr, fi = fft_rows.fft_rows_ct_plain(re, im)  # the four-step transform of K3
    return (fr, fi, *detect_plain(fr, fi, plan, emit_topk))


def topk_plain(score: torch.Tensor, arg: torch.Tensor, k: int):
    """The in-kernel top-K's plain version on ``[..., s]`` partials, and
    the port's one top-K selection (``detect.peaks_from_ct_partials``):
    ``(vals, packed)`` ``[..., 128]``, lane j < k the j-th of k
    masked-argmax passes (:func:`safe.top_k`: the max, the lowest index f
    holding it, an all −inf row picks 0) and ``8·f + arg[f]`` (exact in
    float32); lanes ≥ k are 0."""
    vals, f = safe.top_k(score, k)
    packed = 8.0 * f.to(torch.float32) + torch.gather(arg, -1, f)
    pad = lambda x: torch.nn.functional.pad(x, (0, max(TOPK_LANES - k, 0)))
    return pad(vals), pad(packed)


def detect_plain(fr: torch.Tensor, fi: torch.Tensor, plan: ct_plan.DetectPlan, emit_topk: int = 0):
    """K1's detect body on CT-order spectra: ``(seg_score, seg_arg,
    noise_floor_db, row_max)`` (``detect_kernel._detect_body``); with
    ``emit_topk`` the partials become :func:`topk_plain`'s blocks."""
    rows, n = fr.shape
    n1, n2, seg = plan.n1, plan.n2, ct_plan.SEGMENT
    n2g, s = n2 // seg, plan.segments
    off = plan.power_offset_db

    pr = fr * fr + fi * fi  # [rows, n] linear power, CT flat order
    row_max = pr.amax(dim=-1)

    # noise floor: stride-8 natural subsample = CT rows k2 ≡ 0 (mod 8),
    # bisected in dB; "below" tests an integer count against half
    sub = pr.reshape(rows, n2g, seg, n1)[:, :, 0, :].reshape(rows, s)
    sub_db = 10.0 * torch.log10(sub + 1e-24) + off
    lo = sub_db.amin(dim=-1)
    hi = sub_db.amax(dim=-1)
    for _ in range(plan.bisect_iters):
        mid = 0.5 * (lo + hi)
        count = (sub_db <= mid.unsqueeze(-1)).sum(dim=-1)
        below = 2 * count < s
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    nf = 0.5 * (lo + hi)

    # circular ±radius sliding max in natural bin order (k = k2 + n2·k1)
    r = plan.radius
    nat = pr.reshape(rows, n2, n1).transpose(1, 2).reshape(rows, n)
    ext = torch.cat([nat[:, n - r:], nat, nat[:, :r]], dim=-1)
    smax_nat = ext.unfold(-1, 2 * r + 1, 1).amax(dim=-1)
    smax = smax_nat.reshape(rows, n1, n2).transpose(1, 2).reshape(rows, n)

    # candidacy gates, all in linear power
    m = torch.arange(n, device=fr.device)
    k_nat = (m % n1) * n2 + m // n1
    cand = (pr >= smax) & (pr + 1e-24 > plan.thr_lin)
    cand &= (k_nat >= plan.keep_lo) & (k_nat <= plan.keep_hi)
    if plan.conf_cs is not None:
        conf_lin = torch.exp((nf - off + plan.conf_cs) * ct_plan.LN10_OVER_10)
        cand &= pr + 1e-24 >= conf_lin.unsqueeze(-1)
    score = torch.where(cand, pr, float("-inf"))

    # per-segment (max, lowest in-segment argmax): 8 CT rows of one column
    s4 = score.reshape(rows, n2g, seg, n1)
    seg_max = s4.amax(dim=2)
    offs = torch.arange(seg, device=fr.device).view(1, 1, seg, 1)
    seg_arg = torch.where(s4 >= seg_max.unsqueeze(2), offs, seg).amin(dim=2)
    seg_max, seg_arg = seg_max.reshape(rows, s), seg_arg.reshape(rows, s).to(torch.float32)
    if emit_topk:
        seg_max, seg_arg = topk_plain(seg_max, seg_arg, emit_topk)
    return seg_max, seg_arg, nf, row_max
