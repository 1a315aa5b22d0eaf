"""Kernel K4: spectral detection on CT-order spectra read from memory.

Replaces ``radio_mapper_tpu/ops/pallas/detect_kernel.py::detect_ct_partials``
(body ``detect_kernel._detect_body``, ``emit_topk`` 0 or 1..128). The CUDA
source is ``radio_mapper_tpu_torch/csrc/detect_ct.cu``; it runs the parts
of kernel K1's detect epilogue (``csrc/ct_detect.cuh``).

Design: one thread block a row, in two phases,
without holding the row in shared memory, so it takes any length a
detect plan gives (n1 a multiple of :data:`TILE`, radius ≤ n2). Phase a
reads the row once for its max and the stride-8 subsample's dB values
(n/8 floats in shared memory) and runs the 24-step dB bisection of the
noise floor over them. Phase b walks tiles of :data:`TILE` columns k1,
each a run of n2 natural bins, read again with a halo of radius bins from
the neighbour columns (circular), and runs the circular ±radius sliding
max in natural bin order, the gates and the per-8-bin-segment (max,
lowest argmax). With ``emit_topk = K`` phase b writes the partials to a
scratch this wrapper allocates and a phase c in the same block (same
launch) reads them back and runs K block-wide masked-argmax passes
(``ct_detect.cuh`` ``block_topk``), writing a [rows, 128] block of values
and packed 8·f + offset. Every reduction is a max, a min or a count, so
on K1's own spectra K4 gives K1's partials and noise floor bit for bit,
and the top-K block equals the partials followed by the port's top-K
tail. The reference's ``rows_per_block`` and row padding tile the TPU's
VMEM and are dropped.

What bounds it on the H100: device-memory bytes — the spectra read twice
(16 B a bin) and the partials written once (1 B a bin), ≈ 0.1 ms at
[1024, 17408] at 3.35 TB/s; the sliding max reads shared memory
2·radius + 1 times per bin. Left for later PRs: a register-tiled sliding
max.

It runs on the two-kernel detect route of the single-dwell pipeline
(K3 → K4, ``detect.set_fused_fft_detect("off")``); kernel K1's long rows
at n1 = 128 and 256 (and at 384, 640, 896 with ``emit_topk``) run it after
the long K3 and take its row max (:mod:`.fft_detect`); at n1 = 384, 640,
896 K1's wide design runs its parts in the transform's own launch.
"""

from __future__ import annotations

import ctypes

import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build, fft_detect

launch_count = 0  # launches of K4 (not of the plain version, nor K1's long rows)

THREADS = 512  # must match K4_THREADS in detect_ct.cu
TILE = 16  # columns k1 a phase-b tile (TILE in detect_ct.cu)

_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    + [ctypes.c_int] + [ctypes.c_void_p] * 3
)


def supported(nfft: int, *, min_distance_bins: int, noise_floor_stride: int) -> bool:
    """Whether the fused detect (K1's epilogue, K4) covers this
    configuration (``detect_kernel.supported``): a CT split with n2 a
    multiple of 8, the stride-8 noise floor, segment exactness (candidates
    ≥ 8 bins apart) and a column at least as tall as the radius."""
    if noise_floor_stride != ct_plan.SEGMENT or min_distance_bins + 1 < ct_plan.SEGMENT:
        return False
    try:
        _n1, n2 = ct_plan.ct_split(nfft)
    except ValueError:
        return False
    return n2 % ct_plan.SEGMENT == 0 and n2 >= min_distance_bins


def detect_ct_partials(spec_re: torch.Tensor, spec_im: torch.Tensor, plan: ct_plan.DetectPlan,
                       emit_topk: int = 0):
    """Per-segment detection partials of ``[rows, nfft]`` CT-order spectra.

    Args:
      spec_re/spec_im: float32 ``[rows, nfft]`` CT-order spectra (kernel K3
        or K1 output).
      plan: :func:`ct_plan.detect_plan` for this nfft.
      emit_topk: 0, or K in 1..128 to finish the selection in the kernel.
    Returns:
      ``(seg_score, seg_arg, noise_floor_db)``: ``[rows, nfft/8]`` linear
      power (−inf where the segment holds no candidate) and float
      in-segment offset 0-7 — segment f = b2·n1 + k1 covers natural bins
      (8·b2 + off) + n2·k1 — and the noise floor in dB, ``[rows]``. With
      ``emit_topk = K``, ``[rows, 128]`` blocks of the K best scores and
      their packed ``8·f + off`` in place of the partials (lanes ≥ K 0),
      as :func:`fft_detect.fft_detect_rows_ct` returns them.

    CPU tensors go through :func:`detect_ct_partials_plain`; CUDA tensors
    launch the kernel (:func:`geometry` checks the length).
    """
    global launch_count
    fft_detect.check_rows(spec_re, spec_im, plan)
    fft_detect.check_topk(emit_topk)
    if spec_re.device.type == "cpu":
        with device.cpu_single_thread():
            return detect_ct_partials_plain(spec_re, spec_im, plan, emit_topk)
    if spec_re.device.type != "cuda":
        raise ValueError(f"no K4 implementation for device {spec_re.device}")
    score, arg, nf, _ = launch(spec_re, spec_im, plan, row_max=False, emit_topk=emit_topk)
    launch_count += 1
    return score, arg, nf


def geometry(nfft: int, radius: int) -> int:
    """The dynamic shared memory K4 takes for rows of nfft bins and a
    ±radius sliding max, decided without a card: the larger of phase a's
    n/8 floats and phase b's tile (``2·TILE·n2 + 2·radius`` floats). Raises
    ValueError unless n1 is a multiple of :data:`TILE`, 8 | n2, radius ≤ n2
    and that fits a block."""
    n1, n2 = ct_plan.ct_split(nfft)
    smem = 4 * max(nfft // ct_plan.SEGMENT, 2 * TILE * n2 + 2 * radius)
    if n1 % TILE or n2 % ct_plan.SEGMENT or not 0 <= radius <= n2 or smem > fft_detect.SMEM_LIMIT:
        raise ValueError(f"K4 takes n1 a multiple of {TILE}, 8 | n2 and radius ≤ n2 within {fft_detect.SMEM_LIMIT} B "
                         f"of shared memory; got nfft {nfft} = {n1}·{n2}, radius {radius}")
    return smem


def launch(fr: torch.Tensor, fi: torch.Tensor, plan: ct_plan.DetectPlan, *, row_max: bool, emit_topk: int = 0):
    """The kernel on ``[rows, nfft]`` CUDA spectra, counted by the caller
    (K4 as one launch of K4, kernel K1's long rows as part of one launch
    of K1): ``(seg_score, seg_arg, noise_floor_db, row_max or None)``, the
    first two the ``[rows, 128]`` top-K blocks with ``emit_topk``."""
    geometry(plan.nfft, plan.radius)
    fn = build.kernel("rm_detect_ct_partials", _ARGTYPES)
    rows, s = fr.shape[0], plan.segments
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=fr.device)
    score, arg, nf = f32(rows, s), f32(rows, s), f32(rows)  # the partials, or the top-K phase's scratch
    rmax = f32(rows) if row_max else None
    top = (f32(rows, fft_detect.TOPK_LANES), f32(rows, fft_detect.TOPK_LANES)) if emit_topk else (None, None)
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    err = fn(
        ptr(fr), ptr(fi), ptr(score), ptr(arg), ptr(nf), ptr(rmax),
        rows, plan.n1, plan.n2, *fft_detect.plan_args(plan),
        emit_topk, ptr(top[0]), ptr(top[1]),
        ctypes.c_void_p(torch.cuda.current_stream(fr.device).cuda_stream),
    )
    build.check(err, "detect_ct_partials")
    if emit_topk:
        return top[0], top[1], nf, rmax
    return score, arg, nf, rmax


def detect_ct_partials_plain(spec_re: torch.Tensor, spec_im: torch.Tensor, plan: ct_plan.DetectPlan,
                             emit_topk: int = 0):
    """Plain PyTorch version of K4: the detect half of K1's plain version.
    Same contract as :func:`detect_ct_partials`. Through its wrapper on the CPU it runs at one intra-op thread
    (:func:`device.cpu_single_thread`, fault F2)."""
    score, arg, nf, _row_max = fft_detect.detect_plain(spec_re, spec_im, plan, emit_topk)
    return score, arg, nf
