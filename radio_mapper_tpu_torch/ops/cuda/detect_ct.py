"""Kernel K4: spectral detection on CT-order spectra read from memory.

Replaces ``radio_mapper_tpu/ops/pallas/detect_kernel.py::detect_ct_partials``
(body ``detect_kernel._detect_body`` with ``emit_topk=0``). The CUDA
source is ``radio_mapper_tpu_torch/csrc/detect_ct.cu``; its body is kernel
K1's detect epilogue (``csrc/ct_detect.cuh``).

Design (first, simple version): one thread block per row reads the row's
spectra once, keeps the linear power ``fr² + fi²`` (69,632 B at nfft
17408) and a scratch of the same size in shared memory, and runs the
detect epilogue there: the 24-step dB bisection over the stride-8
subsample, the circular ±radius sliding max in natural bin order, the
gates and the per-8-bin-segment (max, lowest argmax). The reference's
``rows_per_block`` and row padding tile the TPU's VMEM and are dropped.
On K1's own spectra it gives K1's partials and noise floor bit for bit.

What bounds it on the H100: device-memory bytes — 8 B read and 1 B
written per bin (≈ 160 MB at [1024, 17408], ≈ 0.05 ms at 3.35 TB/s); the
sliding max reads shared memory 2·radius + 1 times per bin. Left for later
PRs: several short rows per block and a register-tiled sliding max.

It runs on the two-kernel detect route of the single-dwell pipeline
(K3 → K4, ``detect.set_fused_fft_detect("off")``).
"""

from __future__ import annotations

import ctypes

import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops.cuda import build, fft_detect

launch_count = 0  # launches of the CUDA kernel (not of the plain version)

THREADS = 512  # must match K4_THREADS in detect_ct.cu

_ARGTYPES = (
    [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int]
    + [ctypes.c_void_p]
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


def detect_ct_partials(spec_re: torch.Tensor, spec_im: torch.Tensor, plan: ct_plan.DetectPlan):
    """Per-segment detection partials of ``[rows, nfft]`` CT-order spectra.

    Args:
      spec_re/spec_im: float32 ``[rows, nfft]`` CT-order spectra (kernel K3
        or K1 output).
      plan: :func:`ct_plan.detect_plan` for this nfft.
    Returns:
      ``(seg_score, seg_arg, noise_floor_db)``: ``[rows, nfft/8]`` linear
      power (−inf where the segment holds no candidate) and float
      in-segment offset 0-7 — segment f = b2·n1 + k1 covers natural bins
      (8·b2 + off) + n2·k1 — and the noise floor in dB, ``[rows]``.

    CPU tensors go through :func:`detect_ct_partials_plain`; CUDA tensors
    launch the kernel.
    """
    fft_detect.check_rows(spec_re, spec_im, plan)
    if spec_re.device.type == "cpu":
        with device.cpu_single_thread():
            return detect_ct_partials_plain(spec_re, spec_im, plan)
    if spec_re.device.type != "cuda":
        raise ValueError(f"no K4 implementation for device {spec_re.device}")
    return _launch(spec_re, spec_im, plan)


def _launch(fr, fi, plan):
    global launch_count
    n1, n2, n = plan.n1, plan.n2, plan.nfft
    if 2 * n * 4 > fft_detect.SMEM_LIMIT:
        raise ValueError(f"K4 keeps 2·nfft floats of a row in shared memory; nfft {n} is too long")
    fn = build.kernel("rm_detect_ct_partials", _ARGTYPES)
    rows, s = fr.shape[0], plan.segments
    score = torch.empty((rows, s), dtype=torch.float32, device=fr.device)
    arg = torch.empty((rows, s), dtype=torch.float32, device=fr.device)
    nf = torch.empty((rows,), dtype=torch.float32, device=fr.device)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    err = fn(
        ptr(fr), ptr(fi), ptr(score), ptr(arg), ptr(nf),
        rows, n1, n2, *fft_detect.plan_args(plan),
        ctypes.c_void_p(torch.cuda.current_stream(fr.device).cuda_stream),
    )
    build.check(err, "detect_ct_partials")
    launch_count += 1
    return score, arg, nf


def detect_ct_partials_plain(spec_re: torch.Tensor, spec_im: torch.Tensor, plan: ct_plan.DetectPlan):
    """Plain PyTorch version of K4: the detect half of K1's plain version.
    Same contract as :func:`detect_ct_partials`. Through its wrapper on the CPU it runs at one intra-op thread
    (:func:`device.cpu_single_thread`, fault F2)."""
    score, arg, nf, _row_max = fft_detect.detect_plain(spec_re, spec_im, plan)
    return score, arg, nf
