"""Kernel K1: forward CT-order FFT + spectral detection in one pass per row.

Replaces ``radio_mapper_tpu/ops/pallas/detect_kernel.py::fft_detect_rows_ct``
(body ``fft_kernel.ct_fft_core`` + ``detect_kernel._detect_body``). The
CUDA source is ``radio_mapper_tpu_torch/csrc/fft_detect.cu``.

Two designs, chosen by length inside :func:`fft_detect_rows_ct`
(:func:`geometry`); a length neither takes raises ``ValueError``.

Up to :data:`MAX_N` (``csrc/fft_detect.cu``): one 512-thread block per row
keeps the whole row (re+im, 139,264 B at nfft 17408) in shared memory and
runs kernel K3's radix steps on it (``csrc/ct_fft.cuh`` ``fft_power_row``):
every such row is n = 128·n2 with n2 = 8·r, r ≤ 24
(:func:`ct_plan.radix_split`; a detect plan has 8 | n2), so step A is an
8-point radix-2 FFT and step B a direct r-point DFT with its inputs in
registers; step C, a warp-shuffle 128-point FFT per slot row, stores the
spectra as K3 does (K1's spectra equal K3's bit for bit) and hands each
value's power to the detect body through registers (at most 48 a
thread), written back over the row in CT order after a barrier. The
detect body then runs on that power array (``csrc/ct_detect.cuh``,
shared with kernel K8; K4 runs its parts on column tiles): row max, the
24-step dB bisection over the stride-8 subsample, the circular ±radius
sliding max in natural bin order, the gates, and the per-8-bin-segment
(max, lowest argmax). With ``emit_topk = K`` (1..128, the reference's
in-kernel top-K) those partials stay in shared memory and K block-wide
masked-argmax passes over them (``ct_detect.cuh`` ``block_topk``: a max,
then the lowest index holding it) write a [rows, 128] block of values and
packed 8·f + offset in place of the F/8 partials; the long rows run K4's
same phase.

Above :data:`MAX_N` (:func:`fft_detect_rows_ct_long`), for every n1 the
long-row K3 takes (128, 256, 384, 640, 896), by n1
(:func:`fft_rows.long_geometry`):

- n1 = 384, 640, 896, the wide design (``csrc/fft_detect_cluster.cuh``, a
  template on n1; :func:`wide_detect`): one launch, a row on a
  thread-block cluster of 8 blocks. Each block transforms n1/8 columns
  and then its CT rows k2 ≡ rank (mod 8) through distributed shared
  memory, stores the spectra and keeps their power; block 0's rows are
  the stride-8 subsample, so it finds the noise floor alone and hands it
  to the others; each block then pulls its columns' power in natural
  order from the 8 blocks and runs the sliding max, the gates and the
  segment partials. One pass through device memory, 16 B a sample, and
  K3 → K4's outputs bit for bit. With ``emit_topk`` it is K3 (the same
  kernel, its detect half off) and then K4's phase c: the in-kernel top-K
  is not fused at these n1.
- n1 = 128, 256: two hand-written kernels in turn, the long-row K3
  (``csrc/fft_rows_ct_cluster.cu``, a row on a thread-block cluster) and
  then K4 (``csrc/detect_ct.cu``, which holds no row in shared memory) on
  its spectra, with the row max. The reference's function is that
  composition, so the outputs are those of K3 → K4 bit for bit; the pair
  counts as one launch of K1.

What bounds it on the H100: device-memory bytes (the row read and the
spectra written once, ≈ 0.28 MB a row at 17408; the long design writes
the spectra and reads them back twice) and then
the block barriers and shared-memory passes of the radix steps and of the
detect body, whose sliding max reads the power 2·radius + 1 times. Left for
later PRs: the detect body (a register-tiled sliding max), TMA row loads,
and fusing K1 into the pair stage (K2) so the spectra never reach device
memory.
"""

from __future__ import annotations

import ctypes

import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan, safe
from radio_mapper_tpu_torch.ops.cuda import build, detect_ct, fft_rows

launch_count = 0  # launches of K1 (not of the plain version); a long-row call counts once
design_counts = {"block": 0, "long": 0, "wide": 0}  # the same launches, by design ("long": K3 → K4)

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


def geometry(n: int) -> str:
    """K1's design for rows of n samples, decided without a card:
    ``"block"`` (:func:`radix_geometry`) or ``"long"`` (n > :data:`MAX_N`,
    the long-row K3's lengths, :func:`fft_rows.geometry`). Raises
    ValueError otherwise."""
    if n <= MAX_N:
        radix_geometry(n)
        return "block"
    return fft_rows.geometry(n)  # "long" above MAX_N, or it raises


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
    launch the design :func:`geometry` picks: one kernel up to
    :data:`MAX_N`, above it the long-row K3 and K4 in turn.
    """
    check_rows(re, im, plan)
    check_topk(emit_topk)
    if re.device.type == "cpu":
        with device.cpu_single_thread():
            return fft_detect_rows_ct_plain(re, im, plan, emit_topk)
    if re.device.type != "cuda":
        raise ValueError(f"no K1 implementation for device {re.device}")
    if geometry(plan.nfft) == "long":
        return fft_detect_rows_ct_long(re, im, plan, emit_topk)
    return _launch(re, im, plan, emit_topk)


def fft_detect_rows_ct_long(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan, emit_topk: int = 0):
    """:func:`fft_detect_rows_ct` through the long-row design on CUDA rows
    of a length :func:`fft_rows.long_geometry` takes, counted as one launch
    of K1: at n1 = 384, 640, 896 without ``emit_topk`` the wide design's one kernel
    (``design_counts["wide"]``), else the long K3 and then K4 with the row
    max (``"long"``). The wrapper routes only n > :data:`MAX_N` here; the
    card tests also force shorter rows through it, where its outputs equal
    the one-block K1's bit for bit."""
    global launch_count
    check_rows(re, im, plan)
    check_topk(emit_topk)
    if re.device.type != "cuda":
        raise ValueError(f"the long-row K1 runs on CUDA tensors, not {re.device}")
    if fft_rows.long_geometry(plan.nfft).design == "wide" and not emit_topk:
        out = wide_detect(re, im, plan)
        design = "wide"
    else:
        fr, fi = fft_rows.long_rows(re, im)
        out = (fr, fi, *detect_ct.launch(fr, fi, plan, row_max=True, emit_topk=emit_topk))
        design = "long"
    launch_count += 1
    design_counts[design] += 1
    return out


def wide_detect(re: torch.Tensor, im: torch.Tensor, plan: ct_plan.DetectPlan):
    """K1 through the wide design (n1 = 384, 640, 896, ``csrc/fft_detect_cluster.cuh``
    with its detect half on) on contiguous float32 CUDA rows, uncounted:
    ``(fr, fi, seg_score, seg_arg, noise_floor_db, row_max)`` from one
    launch (:func:`fft_rows.wide_launch`), without ``emit_topk``. Kernel
    K8's long design calls it too."""
    if plan.nfft != re.shape[-1] or plan.radius < 2:
        raise ValueError(
            f"the wide K1 takes a plan for nfft {re.shape[-1]} with radius ≥ 2, got {plan.nfft}, {plan.radius}"
        )
    rows = re.numel() // plan.nfft
    det = tuple(
        torch.empty(shape, dtype=torch.float32, device=re.device)
        for shape in ((rows, plan.segments), (rows, plan.segments), (rows,), (rows,))
    )
    fr, fi = fft_rows.wide_launch(re, im, det, tuple(plan_args(plan)))
    return (fr, fi, *det)


def _launch(re, im, plan, emit_topk):
    global launch_count
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
    launch_count += 1
    design_counts["block"] += 1
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
