"""Split-complex (separate float32 re/im) channelizer and receiver spectra.

Port of ``radio_mapper_tpu/ops/split_complex.py``: ``channelize_split``
(the PFB channelizer on (re, im) pairs) and ``receiver_spectra_ct``
(zero-pad to the planner's nfft, then the CT-order forward FFT — kernel
K3 on a CUDA device, its plain version on the CPU).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from radio_mapper_tpu_torch.ops import channelizer, ct_plan
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops.cuda import fft_rows


def channelize_split(
    re: torch.Tensor,
    im: torch.Tensor,
    num_channels: int,
    *,
    sample_rate_hz: float,
    taps_per_channel: int = 8,
    shift: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polyphase channelizer on split-complex ``[..., N]`` input.

    The prototype filter is real, so each part is filtered on its own and
    only the M-point branch DFT mixes them. Returns ``(ch_re, ch_im)`` of
    shape ``[..., M, F]`` with F = N/M − T + 1 frames; channel c is the
    offset c·fs/M (aliased) unless ``shift``, which rolls the channel
    axis by M/2 so offsets increase from −fs/2. ``sample_rate_hz`` is
    kept for the reference's signature; the output does not depend on it.
    """
    m, t = num_channels, taps_per_channel
    n = re.shape[-1]
    if n % m != 0:
        raise ValueError(f"block length {n} must be a multiple of num_channels {m}")
    num_cols = n // m
    num_frames = num_cols - t + 1
    if num_frames <= 0:
        raise ValueError(f"need at least {m * t} samples, got {n}")
    h = channelizer.prototype_filter_on(m, t, re.device)

    def filter_part(x):
        cols = x.reshape(*x.shape[:-1], num_cols, m)
        return channelizer.polyphase_filter_apply(cols, h, num_frames)

    cre, cim = fft_ops.dft_direct(filter_part(re), filter_part(im))  # branch DFT over M
    cre = cre.movedim(-1, -2)
    cim = cim.movedim(-1, -2)
    if shift:
        cre = torch.roll(cre, m // 2, dims=-2)
        cim = torch.roll(cim, m // 2, dims=-2)
    return cre, cim


def receiver_spectra_ct(
    sig_re: torch.Tensor, sig_im: torch.Tensor, *, max_lag: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-receiver CT-order spectra for the pair stage.

    ``sig_re/sig_im [..., n]`` are zero-padded to
    ``nfft = ct_plan.plan_nfft(n + max_lag)`` (alias-free for ±max_lag) and
    transformed by kernel K3 in one launch over all leading rows. Returns
    ``(fr, fi, nfft)`` with ``fr/fi [..., nfft]``.
    """
    n = sig_re.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < block length {n}")
    nfft = ct_plan.plan_nfft(n + max_lag)
    pad = lambda a: F.pad(a, (0, nfft - n)).contiguous()
    fr, fi = fft_rows.fft_rows_ct(pad(sig_re), pad(sig_im))
    return fr, fi, nfft
