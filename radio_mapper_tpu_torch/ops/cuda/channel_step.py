"""Kernel K8: the per-channel megakernel — FFT × detect × GCC pair stage.

Replaces ``radio_mapper_tpu/ops/pallas/channel_kernel.py::channel_step_partials``
(``ct_fft_core`` + ``_detect_body`` + the l2rx ``_whiten`` +
``_invert_to_lag_windows``, one grid cell per channel). The CUDA source is
``radio_mapper_tpu_torch/csrc/channel_step.cu``.

Two designs, chosen by length inside :func:`channel_step_partials`
(:func:`geometry`): "cluster" up to :data:`fft_detect.MAX_N`, "long"
above.

Cluster design (first, simple version): a channel is a thread-block cluster of B
blocks, one per receiver (a complex row at nfft 17408 is 139,264 B, so a
channel's 8 rows cannot share one block's 227 KB as the TPU kernel's VMEM
holds them). Each block runs kernel K1's body on its row — K3's radix
steps in shared memory (``csrc/ct_fft.cuh`` ``fft_power_row``), the
spectra to a scratch that this wrapper allocates and the power through
registers to the detect body, the detect partials and noise floor to the
outputs, the row max to a per-receiver gate scratch — then the cluster
synchronises and block ``rank`` runs kernel K2's pair body (l2rx gate,
``csrc/gcc_pair_wide.cuh``: bulk copies of the partners' spectra, the
fold on tensor cores) on K2's tiles rank, rank + B, ... in the shared
memory the row no longer needs (:func:`pair_plan`). The same device
functions run in the same order, with the same template arguments, as K1
→ K2 (l2rx); the pair body folds a window by the same k-steps at any
block size, chunk or tile, so the outputs equal that composition's bit
for bit. Keeping each spectrum in its block's shared
memory and reading partners through distributed shared memory would drop
the scratch's traffic (2 × 142.6 MB at 128 channels × 8 receivers) but
needs ≈ 209 KB a block before the pair buffers: a later redesign.

Long design (nfft > 24576, where one block no longer holds a row): the
long K1 — its one-pass kernel on a thread-block cluster at every n1
(``csrc/fft_rows_ct_cluster.cu`` with its detect half at n1 = 128, 256,
``csrc/fft_detect_cluster.cuh`` at 384, 640, 896; the long K3 and then
K4 of ``csrc/detect_ct.cu`` only for a radius outside 2 .. n2) — then
K2's launch (``csrc/gcc_pair.cu``, l2rx gate on those maxima): two
launches, counted as one launch of K8 (and not of K1, K3, K4 or K2). The
reference's K8 takes every length ``ct_supported`` accepts; its function
is K1 → K2 (l2rx), so the outputs equal that composition bit for bit.
K2 fused into the long K1 is a later redesign.

What bounds it on the H100 as written: one 512-thread block per SM (the
row's shared memory stays reserved) for both halves; the forward half is
K1's radix body (≈ 3.5 GFLOP with the detect body), bound by its bytes
and barriers; the pair half K2's body. The function itself needs ≈ 4.9 GFLOP
with FFTs (≈ 0.07 ms at 67 TFLOP/s).

Routing (``channel_kernel.set_mega_fused``/``supported``, copied): "off"
by default, "auto" follows "off"; the kernel needs "phat", B padded to a
multiple of 8 at most 16 and P padded at most 64, so at most 11
receivers reach it (55 pairs pad to 56). The wrapper itself takes B ≤ 16:
a cluster of 16 blocks of 139 KB launches on the H100 (card test). The
gate is always "l2rx", whatever :func:`gcc_pair.set_phat_gate` says.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build, detect_ct, fft_detect, fft_rows, gcc_pair

launch_count = 0  # launches of the CUDA kernel (not of the plain version); a long-row call counts once
design_counts = {"cluster": 0, "long": 0}  # the same launches, by design

THREADS = 512  # must match K8_THREADS in channel_step.cu (K1's block)
MAX_PAIR_ROWS = 64  # channel_kernel.MAX_PAIR_ROWS
MAX_B_PAD = 16  # channel_kernel.MAX_B_PAD

_ARGTYPES = (
    [ctypes.c_void_p] * 17
    + [ctypes.c_int] * 14
    + [ctypes.c_float] * 2
    + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    + [ctypes.c_void_p]
)

_MEGA = "off"


def set_mega_fused(mode: str) -> None:
    """Route the single-dwell step to K8 ("on"), or not ("off", "auto":
    the reference's measured-neutral default)."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown mega-fused mode {mode!r}")
    global _MEGA
    _MEGA = mode


def supported(
    nfft: int,
    num_receivers: int,
    *,
    min_distance_bins: int,
    noise_floor_stride: int,
    weighting: str,
) -> bool:
    """``channel_kernel.supported``: whether the step routes to K8."""
    if _MEGA != "on":
        return False
    if weighting != "phat":
        return False
    if -(-num_receivers // 8) * 8 > MAX_B_PAD:
        return False
    p = num_receivers * (num_receivers - 1) // 2
    if -(-p // 8) * 8 > MAX_PAIR_ROWS:
        return False
    if not detect_ct.supported(
        nfft, min_distance_bins=min_distance_bins, noise_floor_stride=noise_floor_stride
    ):
        return False
    return ct_plan.ct_supported(nfft)


def geometry(n: int) -> str:
    """K8's design for rows of n samples, decided without a card:
    ``"cluster"`` (K1's one-block body, :func:`fft_detect.radix_geometry`,
    nfft ≤ :data:`fft_detect.MAX_N`) or ``"long"`` (above, the long K1's
    lengths, :func:`fft_rows.long_geometry`). Raises ValueError
    otherwise."""
    if n > fft_detect.MAX_N:
        fft_rows.long_geometry(n)
        return "long"
    fft_detect.radix_geometry(n, "K8 (K1's body, then K2's)")
    return "cluster"


def pair_plan(n: int, nneg: int, npos: int) -> gcc_pair.WidePlan:
    """K8's pair half (``csrc/channel_step.cu``): K2's body at n1 = 128 in
    the shared memory of the block's row (n complex floats; W_128 after it
    stays), on K2's tiles of two pairs where they fit, else one pair a
    block, 16 rows a chunk (fewer where they do not fit: the block has the
    SM to itself, so K2's 8 rows for a third block would buy nothing);
    raises where even one pair does not fit."""
    n1, n2 = ct_plan.ct_split(n)
    rows = gcc_pair.CHUNK_ROWS[n1][0]
    try:
        return gcc_pair.wide_plan(n1, n2, nneg, npos, 2, limit=n * 8, rows=rows)
    except ValueError:
        return gcc_pair.wide_plan(n1, n2, nneg, npos, 1, limit=n * 8, rows=rows)


def channel_step_partials(
    re_pad: torch.Tensor,
    im_pad: torch.Tensor,
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    plan: ct_plan.DetectPlan,
    max_lag: int,
    eps: float = 0.05,
):
    """Detect partials and lag windows of every channel, one launch.

    Args:
      re_pad/im_pad: float32 ``[..., B, nfft]`` time rows, zero-padded to
        ``plan.nfft``.
      pair_i/pair_j: host int arrays of length P.
      plan: :func:`ct_plan.detect_plan` for this nfft.
    Returns:
      ``(seg_score [..., B, nfft/8], seg_arg [..., B, nfft/8],
      noise_floor_db [..., B], lag_mags [..., P, 2·max_lag+1])``: K1's
      partials and floor, and K2's windows under the l2rx gate with K1's
      row maxima as the gate input.

    CPU tensors go through :func:`channel_step_partials_plain`; CUDA
    tensors launch the kernel.
    """
    if re_pad.shape != im_pad.shape or re_pad.dim() < 2 or re_pad.numel() == 0:
        raise ValueError(f"need re/im [..., B, nfft], got {tuple(re_pad.shape)}, {tuple(im_pad.shape)}")
    *lead, b, n = re_pad.shape
    fft_detect.check_rows(re_pad.reshape(-1, n), im_pad.reshape(-1, n), plan)
    if not (re_pad.is_contiguous() and im_pad.is_contiguous()):
        raise ValueError("re/im must be contiguous")
    gcc_pair._check_pairs(pair_i, pair_j, b)
    gcc_pair._check_lag(n, max_lag)
    if re_pad.device.type == "cpu":
        with device.cpu_single_thread():
            return channel_step_partials_plain(re_pad, im_pad, pair_i, pair_j, plan, max_lag, eps)
    if re_pad.device.type != "cuda":
        raise ValueError(f"no K8 implementation for device {re_pad.device}")
    return _launch(re_pad, im_pad, pair_i, pair_j, plan, max_lag, eps)


def _launch(re, im, pair_i, pair_j, plan, max_lag, eps):
    global launch_count
    *lead, b, n = re.shape
    if geometry(n) == "long":
        out = _long(re, im, pair_i, pair_j, plan, max_lag, eps)
        launch_count += 1
        design_counts["long"] += 1
        return out
    n2, a, r = fft_detect.radix_geometry(n, "K8 (K1's body, then K2's)")
    n1 = ct_plan.ct_split(n)[0]  # 128: K1's one-block body
    if b > MAX_B_PAD:
        raise ValueError(f"K8 runs a cluster of one block per receiver: at most {MAX_B_PAD}, got {b}")
    nneg, npos = gcc_pair.window_rows(n, max_lag)
    pp = pair_plan(n, nneg, npos)
    fn = build.kernel("rm_channel_step_partials", _ARGTYPES)
    dev = re.device
    w128, wn2, wr = ct_plan.device_radix_tables(n, dev)
    ftw = ct_plan.device_tables(n, False, dev).tw
    iwr, iw2, itwx = gcc_pair._tables(n, n1, dev)  # the pair body's tables
    tiles = gcc_pair.device_tiles(pair_i, pair_j, pp.pairs, dev)
    c, p, s, width = re.numel() // (b * n), len(pair_i), plan.segments, 2 * max_lag + 1
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    fr, fi, smax = f32(c, b, n), f32(c, b, n), f32(c, b)  # scratch: spectra, row maxima
    score, arg, nf, out = f32(c, b, s), f32(c, b, s), f32(c, b), f32(c, p, width)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = fn(
        ptr(re), ptr(im), ptr(w128), ptr(wn2), ptr(wr), ptr(ftw), ptr(iwr), ptr(iw2), ptr(itwx),
        ptr(tiles), ptr(fr), ptr(fi), ptr(smax),
        ptr(score), ptr(arg), ptr(nf), ptr(out),
        c, b, p, tiles.shape[0], n2, a, r, nneg, npos, max_lag,
        pp.nsrc, pp.rows, pp.ntg, pp.groups,
        eps * eps, 1.0 / n,
        *fft_detect.plan_args(plan),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    build.check(err, "channel_step_partials")
    launch_count += 1
    design_counts["cluster"] += 1
    return (
        score.reshape(*lead, b, s), arg.reshape(*lead, b, s), nf.reshape(*lead, b),
        out.reshape(*lead, p, width),
    )


def _long(re, im, pair_i, pair_j, plan, max_lag, eps):
    """K8's long design on CUDA rows ``[..., B, n]``: the long K1 (its
    one-launch cluster design: at n1 = 128, 256 ``fft_detect.cluster_detect``,
    at 384, 640, 896 ``fft_detect.wide_detect``; for a plan neither takes,
    the long K3 and K4 with the row maxima), then K2's kernel (l2rx), none
    of them counted: two launches at every n1."""
    *lead, b, n = re.shape
    rows = (re.reshape(-1, n), im.reshape(-1, n))
    one = fft_detect.one_pass_design(n, 0, plan.radius)
    if one == "cluster":
        fr, fi, score, arg, nf, rmax = fft_detect.cluster_detect(*rows, plan)
    elif one == "wide":
        fr, fi, score, arg, nf, rmax = fft_detect.wide_detect(*rows, plan)
    else:
        fr, fi = fft_rows.long_rows(*rows)
        score, arg, nf, rmax = detect_ct.launch(fr, fi, plan, row_max=True)
    c, s = fr.shape[0] // b, plan.segments
    mags = gcc_pair.launch_k2(
        fr.reshape(c, b, n), fi.reshape(c, b, n), rmax.reshape(c, b), pair_i, pair_j, max_lag, eps, "l2rx"
    )
    return (
        score.reshape(*lead, b, s), arg.reshape(*lead, b, s), nf.reshape(*lead, b),
        mags.reshape(*lead, mags.shape[-2], mags.shape[-1]),
    )


def channel_step_partials_plain(re_pad, im_pad, pair_i, pair_j, plan, max_lag, eps=0.05):
    """Plain PyTorch version of K8: plain K1, then plain K2 with the l2rx
    gate on K1's row maxima. Same contract as :func:`channel_step_partials`.
    Through its wrapper on the CPU it runs at one intra-op thread
    (:func:`device.cpu_single_thread`, fault F2)."""
    *lead, b, n = re_pad.shape
    fr, fi, score, arg, nf, rmax = fft_detect.fft_detect_rows_ct_plain(
        re_pad.reshape(-1, n), im_pad.reshape(-1, n), plan
    )
    mags = gcc_pair._k2_plain(
        fr.reshape(-1, b, n), fi.reshape(-1, b, n), rmax.reshape(-1, b),
        pair_i, pair_j, max_lag, eps, "l2rx",
    )
    s = plan.segments
    return (
        score.reshape(*lead, b, s), arg.reshape(*lead, b, s), nf.reshape(*lead, b),
        mags.reshape(*lead, mags.shape[-2], mags.shape[-1]),
    )
