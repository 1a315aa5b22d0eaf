"""Split-complex (separate float32 re/im) spectra, channelizer and GCC.

Port of ``radio_mapper_tpu/ops/split_complex.py``:

- ``channelize_split`` (the PFB channelizer on (re, im) pairs) and
  ``receiver_spectra_ct`` (zero-pad to the planner's nfft, then the
  CT-order forward FFT — kernel K3 on a CUDA device, its plain version
  on the CPU);
- ``power_spectrum_db_split``, ``receiver_spectra_split``, ``ifft_re_im``
  and ``gcc_phat_all_pairs_split``: the natural-order chain of the
  multi-dwell route, on :func:`.fft.fft_re_im` (kernel K7 for the
  lengths it routes there, the matmul four-step otherwise). Its whitening
  is the textbook ``|.| + eps·max|.|`` gate per pair, not the fused
  kernels' l2rx gate.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from radio_mapper_tpu_torch.ops import channelizer, ct_plan, gcc_phat
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops.cuda import fft_rows

WEIGHTINGS = ("cc", "phat", "scot", "roth")


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

    cre, cim = fft_ops.fft_re_im(filter_part(re), filter_part(im))  # branch DFT over M
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


def power_spectrum_db_split(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``10·log10(|FFT|² + 1e-24)`` over the last axis, natural bin order."""
    fre, fim = fft_ops.fft_re_im(re, im)
    return 10.0 * torch.log10(fre * fre + fim * fim + 1e-24)


def ifft_re_im(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse DFT over the last axis by the conjugation identity."""
    n = re.shape[-1]
    yre, yim = fft_ops.fft_re_im(re, -im)
    return yre / n, -yim / n


def receiver_spectra_split(
    sig_re: torch.Tensor, sig_im: torch.Tensor, *, max_lag: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-receiver natural-order spectra for the pair stage: ``sig_re/
    sig_im [..., n]`` zero-padded to ``nfft = friendly_fft_len(n +
    max_lag)`` (alias-free for ±max_lag) and transformed. Returns
    ``(fr, fi, nfft)``."""
    n = sig_re.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < block length {n}")
    nfft = fft_ops.friendly_fft_len(n + max_lag)
    pad = lambda a: F.pad(a, (0, nfft - n))
    fr, fi = fft_ops.fft_re_im(pad(sig_re), pad(sig_im))
    return fr, fi, nfft


def gcc_lag_mags_split(
    fr: torch.Tensor,
    fi: torch.Tensor,
    pair_i: torch.Tensor,
    pair_j: torch.Tensor,
    *,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> torch.Tensor:
    """|r| over lags −max_lag..max_lag for every pair, ``[..., P, 2L+1]``,
    from natural-order receiver spectra ``fr/fi [..., B, nfft]``.

    R = X_i·conj(X_j), weighted by 1/(D + eps·max D + 1e-30) with D = |R|
    ("phat"), √(|X_i|²|X_j|²) ("scot"), |X_i|² ("roth"), or unweighted
    ("cc"), then the inverse transform and the lag window.
    """
    if weighting not in WEIGHTINGS:
        raise ValueError(f"unknown weighting {weighting!r}")
    nfft = fr.shape[-1]
    xfr, xfi = fr.index_select(-2, pair_i), fi.index_select(-2, pair_i)
    yfr, yfi = fr.index_select(-2, pair_j), fi.index_select(-2, pair_j)
    rre = xfr * yfr + xfi * yfi  # R = X · conj(Y)
    rim = xfi * yfr - xfr * yfi
    if weighting != "cc":
        if weighting == "phat":
            denom_base = torch.sqrt(rre * rre + rim * rim)
        elif weighting == "scot":
            denom_base = torch.sqrt((xfr * xfr + xfi * xfi) * (yfr * yfr + yfi * yfi))
        else:  # roth
            denom_base = xfr * xfr + xfi * xfi
        scale = denom_base.amax(dim=-1, keepdim=True)
        denom = denom_base + eps * scale + 1e-30
        rre = rre / denom
        rim = rim / denom
    cre, cim = ifft_re_im(rre, rim)
    take = lambda a: torch.cat([a[..., nfft - max_lag:], a[..., : max_lag + 1]], dim=-1)
    cre, cim = take(cre), take(cim)
    return torch.sqrt(cre * cre + cim * cim)


def gcc_phat_all_pairs_split(
    sig_re: torch.Tensor,
    sig_im: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
    psr_exclude: int = 8,
    spectra: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
) -> gcc_phat.CorrelationPeak:
    """All i<j pairs over the receiver axis of ``[..., B, N]`` float32
    pairs: each receiver is transformed once (or ``spectra`` from
    :func:`receiver_spectra_split` are reused), then
    :func:`gcc_lag_mags_split` and the sub-sample peak pick."""
    fr, fi, nfft = (
        spectra if spectra is not None
        else receiver_spectra_split(sig_re, sig_im, max_lag=max_lag)
    )
    if nfft < sig_re.shape[-1] + max_lag or fr.shape[-1] != nfft:
        raise ValueError(
            f"provided spectra (nfft={nfft}, last dim {fr.shape[-1]}) violate the "
            f"alias-free bound for block {sig_re.shape[-1]} + max_lag {max_lag}"
        )
    i_idx, j_idx = gcc_phat.pair_indices(sig_re.shape[-2])
    as_idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=fr.device)
    mags = gcc_lag_mags_split(
        fr, fi, as_idx(i_idx), as_idx(j_idx), max_lag=max_lag, weighting=weighting, eps=eps
    )
    return gcc_phat.peaks_from_lag_mags(
        mags, sample_rate_hz=sample_rate_hz, max_lag=max_lag, psr_exclude=psr_exclude
    )
