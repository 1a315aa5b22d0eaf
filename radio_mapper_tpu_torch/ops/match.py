"""Snippet pattern matching: normalized circular cross-correlation.

Port of ``radio_mapper_tpu/ops/match.py``. A query snippet is scored
against a batch of stored snippets, invariant to circular time shift,
amplitude and carrier phase: split re/im float32 throughout, a forward
:func:`.fft.fft_re_im` of each side, the cross spectrum, and the inverse
by conjugation. At the buoy's 256-sample snippets the transforms are the
plain matmul four-step on any device (shorter than kernel K7's rows).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from radio_mapper_tpu_torch.ops import fft as fft_ops


def snippet_match_scores(
    hist_re: torch.Tensor,
    hist_im: torch.Tensor,
    query_re: torch.Tensor,
    query_im: torch.Tensor,
    *,
    eps: float = 1e-12,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score stored snippets ``[M, N]`` against a query ``[N]``.

    Returns ``(scores [M], lags [M])``: the peak magnitude of the circular
    cross-correlation over both energies (1.0 for the same waveform at any
    circular shift, gain or carrier phase; Cauchy–Schwarz bounds it to
    [0, 1]), and the circular shift of that peak in samples, in [-N/2,
    N/2): positive means the stored snippet is delayed against the query.
    """
    n = hist_re.shape[-1]
    h_re, h_im = hist_re.to(torch.float32), hist_im.to(torch.float32)
    q_re, q_im = query_re.to(torch.float32), query_im.to(torch.float32)
    H_re, H_im = fft_ops.fft_re_im(h_re, h_im)
    Q_re, Q_im = fft_ops.fft_re_im(q_re, q_im)
    # C = H · conj(Q), the query broadcast over the batch
    c_re = H_re * Q_re + H_im * Q_im
    c_im = H_im * Q_re - H_re * Q_im
    # ifft(c) = conj(fft(conj(c))) / N
    y_re, y_im = fft_ops.fft_re_im(c_re, -c_im)
    corr_mag = torch.sqrt(y_re**2 + y_im**2) / n
    norm = torch.sqrt((h_re**2 + h_im**2).sum(dim=-1) * (q_re**2 + q_im**2).sum(dim=-1))
    scores = corr_mag.amax(dim=-1) / (norm + eps)
    peak = corr_mag.argmax(dim=-1)
    lags = torch.where(peak >= n // 2, peak - n, peak)
    return scores, lags


def snippet_match_scores_np(history, query, *, device: torch.device | str = "cuda"):
    """Complex numpy in, numpy ``(scores, lags)`` out; the scoring runs on
    ``device`` (the card by default)."""
    hist = np.atleast_2d(np.asarray(history, np.complex64))
    q = np.asarray(query, np.complex64)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    scores, lags = snippet_match_scores(to(hist.real), to(hist.imag), to(q.real), to(q.imag))
    return scores.cpu().numpy(), lags.cpu().numpy()
