"""Selections with the JAX package's tie-break: lowest index wins.

``torch.topk`` and ``torch.argmax`` leave the order of equal values
unspecified, and the detector's results depend on it (an all −inf row
must select index 0, equal segment maxima the lower segment). These
follow ``radio_mapper_tpu/ops/safe.py``: argmax is max + masked index-min,
top-k is k masked argmaxes (or, segmented, per-segment maxima first);
``pair_select`` gathers by index. The module also holds the safe-mode
reductions of the natural-order detector: the circular ``sliding_max``
and the bisected ``median_bisect``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """Lowest index holding the max of the last axis (int64)."""
    n = x.shape[-1]
    m = x.amax(dim=-1, keepdim=True)
    idx = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(x >= m, idx, n).amin(dim=-1)


def take1_last(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x[..., k] for a per-batch index k ``[...]``."""
    return torch.gather(x, -1, k.unsqueeze(-1)).squeeze(-1)


def pair_select(x: torch.Tensor, idx, axis: int = -1) -> torch.Tensor:
    """``x`` gathered along ``axis`` (−1 or −2) by a shared 1-D index
    vector (``safe.pair_select``). The reference's one-hot product is a
    TPU layout device; ``index_select`` is exact, like its HIGHEST form
    (its bf16 "default" form under PHAT rounds on the TPU only)."""
    if axis not in (-1, -2):
        raise ValueError("pair_select supports axis -1 or -2 only")
    idx = torch.as_tensor(idx, device=x.device).to(torch.int64)
    return x.index_select(axis, idx)


def take_many_last(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x[..., k_j] for a small index set k ``[..., K]``."""
    return torch.gather(x, -1, k)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of the last axis,
    descending, lowest index first among equals; an all −inf row yields
    index 0 in every slot (as ``safe.top_k``)."""
    vals, idxs = [], []
    work = x
    for _ in range(k):
        i = argmax_last(work)
        vals.append(take1_last(work, i))
        idxs.append(i)
        work = work.scatter(-1, i.unsqueeze(-1), float("-inf"))
    return torch.stack(vals, dim=-1), torch.stack(idxs, dim=-1)


def top_k_segmented(x: torch.Tensor, k: int, segment: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k (``safe.top_k_segmented``): each length-``segment``
    block reduces to (max, lowest argmax), then :func:`top_k` runs over the
    block maxima. Equals :func:`top_k` when distinct maxima are at least
    ``segment`` apart; exactly equal candidates inside one block collapse
    to the lower index."""
    *b, n = x.shape
    if n % segment != 0:
        raise ValueError(f"length {n} not divisible by segment {segment}")
    xs = x.reshape(*b, n // segment, segment)
    seg_max = xs.amax(dim=-1)
    idx = torch.arange(segment, device=x.device).expand_as(xs)
    seg_arg = torch.where(xs >= seg_max.unsqueeze(-1), idx, segment).amin(dim=-1)
    vals, seg_sel = top_k(seg_max, k)
    return vals, seg_sel * segment + take_many_last(seg_arg, seg_sel)


def sliding_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over a ±radius window along the last axis with circular edges
    (``safe.sliding_max``, its "window" form): the axis is extended
    circularly by ``radius`` on each side and max-pooled."""
    if radius <= 0:
        return x
    length = x.shape[-1]
    if radius >= length:
        return x.amax(dim=-1, keepdim=True).expand_as(x)
    ext = torch.cat([x[..., -radius:], x, x[..., :radius]], dim=-1)
    pooled = F.max_pool1d(ext.reshape(-1, 1, ext.shape[-1]), 2 * radius + 1, stride=1)
    return pooled.reshape(x.shape)


def median_bisect(x: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Approximate median over the last axis by value-range bisection
    (``safe.median_bisect``): the same float32 steps, so the same value."""
    lo = x.amin(dim=-1)
    hi = x.amax(dim=-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        frac = (x <= mid.unsqueeze(-1)).to(torch.float32).mean(dim=-1)
        below = frac < 0.5
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)
