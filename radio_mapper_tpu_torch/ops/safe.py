"""Selections with the JAX package's tie-break: lowest index wins.

``torch.topk`` and ``torch.argmax`` leave the order of equal values
unspecified, and the detector's results depend on it (an all −inf row
must select index 0, equal segment maxima the lower segment). These
follow ``radio_mapper_tpu/ops/safe.py``: argmax is max + masked index-min,
top-k is k masked argmaxes; ``pair_select`` gathers by index.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
