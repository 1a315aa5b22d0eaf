"""The LM solve of :func:`..solver.solve_tdoa_impl` as one CUDA launch.

Replaces no Pallas kernel: the reference runs its LM as an XLA
``fori_loop``, one program on the TPU; eager PyTorch runs the same loop
(:func:`..solver.lm_loop`, the plain version here) as some 60 small
launches an iteration that the device takes at the host's pace. The
kernel (``csrc/lm_solve.cu``) runs every iteration of every problem in one
launch with the loop's arithmetic, element by element, in float32, and
builds nothing from host memory, so the solve neither waits for the queue
to drain nor for the host's launches.

The problems are the broadcast of the inputs' leading dims, flattened to
N (:func:`flatten_problems`); the layout is picked from P and B
(:func:`layout`: a thread a problem for small networks, a warp a problem
above; the source says why). The launch is wrapped in the program span
``solve.lm.kernel`` (:mod:`...utils.spans`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from radio_mapper_tpu_torch.ops.cuda import build
from radio_mapper_tpu_torch.utils import spans

launch_count = 0  # launches of the CUDA kernel (not of the plain version)
layout_counts = {"thread": 0, "warp": 0}  # the same launches, by layout

THREAD_MAX_PAIRS = 64  # must match lm_solve.cu
THREAD_MAX_RECEIVERS = 16
WARPS = 4  # the warp layout's problems a block

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def layout(p: int, b: int) -> str:
    """``"thread"`` (one thread a problem) for P ≤ 64 pairs on at most 16
    receivers, else ``"warp"`` (one warp a problem)."""
    return "thread" if p <= THREAD_MAX_PAIRS and b <= THREAD_MAX_RECEIVERS else "warp"


def flatten_problems(anchors, dd, w, wsum, x0):
    """``(batch, (anchors [N, B, 3], dd [N, P], w [N, P], wsum [N],
    x0 [N, 3]))``: each input broadcast to the batch shape of them all
    and flattened to N = prod(batch) contiguous rows."""
    b, p = anchors.shape[-2], dd.shape[-1]
    batch = torch.broadcast_shapes(anchors.shape[:-2], dd.shape[:-1], w.shape[:-1], wsum.shape, x0.shape[:-1])
    n = math.prod(batch)

    def flat(t, tail):
        return t.expand((*batch, *tail)).reshape(n, *tail).contiguous()

    return batch, (flat(anchors, (b, 3)), flat(dd, (p,)), flat(w, (p,)), flat(wsum, ()), flat(x0, (3,)))


def lm_solve(anchors, pair_i, pair_j, dd, w, wsum, x0, *, iterations: int, solve_2d: bool):
    """Final position ``[*batch, 3]`` and cost ``[*batch]`` of the LM from
    ``x0``, for float32 ``anchors [..., B, 3]``, ``dd``/``w [..., P]``
    (weights already clamped, an all-zero row already uniform),
    ``wsum [...]`` (Σw + 1e-12) and ``x0 [..., 3]``; ``pair_i``/``pair_j``
    ``[P]`` on the same device, in [0, B). CUDA tensors only: elsewhere
    the solver runs :func:`..solver.lm_loop` itself.
    """
    b, p = anchors.shape[-2], dd.shape[-1]
    if p < 1 or b < 1 or iterations < 0:
        raise ValueError(f"need P ≥ 1 pairs, B ≥ 1 receivers, iterations ≥ 0; got {p}, {b}, {iterations}")
    if pair_i.shape != (p,) or pair_j.shape != (p,):
        raise ValueError(f"pair indices must be [{p}], got {tuple(pair_i.shape)}, {tuple(pair_j.shape)}")
    for t in (anchors, dd, w, wsum, x0):
        if t.dtype != torch.float32 or t.device != dd.device:
            raise ValueError(f"need float32 inputs on {dd.device}, got {t.dtype} on {t.device}")
    batch, flat = flatten_problems(anchors, dd, w, wsum, x0)
    pairs = torch.stack([pair_i, pair_j], dim=-1).to(torch.int32)
    x, cost = _launch(*flat, pairs, iterations, solve_2d)
    return x.reshape(*batch, 3), cost.reshape(batch)


def _launch(anchors, dd, w, wsum, x0, pairs, iterations, solve_2d):
    """``(x [N, 3], cost [N])`` of the kernel on the flat problems."""
    global launch_count
    if dd.device.type != "cuda":
        raise ValueError(f"the LM kernel runs on CUDA tensors, not on {dd.device}")
    n, b, _ = anchors.shape
    p = dd.shape[-1]
    x = torch.empty((n, 3), dtype=torch.float32, device=dd.device)
    cost = torch.empty((n,), dtype=torch.float32, device=dd.device)
    if n == 0:
        return x, cost
    kind = layout(p, b)
    fn = build.kernel("rm_lm_solve", _ARGTYPES)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream(dd.device).cuda_stream)
    with spans.span("solve.lm.kernel"):
        err = fn(
            ptr(anchors), ptr(dd), ptr(w), ptr(wsum), ptr(x0), ptr(pairs), ptr(x), ptr(cost),
            n, b, p, iterations, int(solve_2d), int(kind == "warp"), stream,
        )
    build.check(err, "lm_solve")
    launch_count += 1
    layout_counts[kind] += 1
    return x, cost
