"""Split-complex (separate float32 re/im) spectra, channelizer and GCC.

Port of ``radio_mapper_tpu/ops/split_complex.py``:

- ``channelize_split`` (the PFB channelizer on (re, im) pairs) and
  ``receiver_spectra_ct`` (zero-pad to the planner's nfft, then the
  CT-order forward FFT — kernel K3 on a CUDA device, its plain version
  on the CPU);
- the single-dwell step's fused stages: ``receiver_spectra_ct_detect``
  (kernel K1: spectra + detect partials + row maxima),
  ``flagship_channel_step`` (kernel K8: partials + lag windows, no
  spectra), ``ct_power_db`` (CT-order spectra → natural-order dB, an
  un-permute, not a second FFT) and ``gcc_phat_all_pairs_split_fused``
  (kernel K2 on CT-order spectra), with the route knob
  ``set_gcc_fused``/``gcc_fused_mode``/``gcc_fused_enabled``;
- ``power_spectrum_db_split``, ``receiver_spectra_split``, ``ifft_re_im``,
  ``gcc_phat_all_pairs_split``, and the pairwise ``cross_correlate_split``
  and ``gcc_phat_split`` (``CorrelationPeakSC``): the natural-order chain of the
  multi-dwell route, on :func:`.fft.fft_re_im` (kernel K7 for the
  lengths it routes there, the matmul four-step otherwise). Its weighting
  is :func:`.gcc_phat.weighted_lag_window`, the complex GCC's own body:
  the textbook ``|.| + eps·max|.|`` gate per pair, not the fused
  kernels' l2rx gate.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from radio_mapper_tpu_torch.ops import channelizer, ct_plan, gcc_phat
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops.cuda import channel_step, fft_detect, fft_rows, gcc_pair

WEIGHTINGS = gcc_phat.WEIGHTINGS

# Route of the single-dwell pair stage: the fused CT-order chain (K1/K3 →
# K2, or K8) for the weightings kernel K2 takes, or the natural-order
# split GCC below. "auto" means what it means on the TPU (the fused chain
# where supported); "on" is the same; "off" never fuses.
_GCC_FUSED = "auto"


def set_gcc_fused(mode: str) -> None:
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused-GCC mode {mode!r}")
    global _GCC_FUSED
    _GCC_FUSED = mode


def gcc_fused_mode() -> str:
    """The route knob ("auto", "on" or "off"): the multi-device steps fuse
    on CPU ranks only when it is forced "on", as the reference does off
    the TPU."""
    return _GCC_FUSED


def gcc_fused_enabled(min_len: int, weighting: str) -> bool:
    """Route the pair stage to the fused CT-order chain?"""
    if _GCC_FUSED == "off":
        return False
    return weighting in gcc_pair.WEIGHTINGS and ct_plan.ct_supported(ct_plan.plan_nfft(min_len))


# The reference's name for the split GCC's peak tuple: the same fields.
CorrelationPeakSC = gcc_phat.CorrelationPeak


def planned_ct_nfft(min_len: int) -> int:
    """The fused chain's FFT length for ``min_len`` samples."""
    return ct_plan.plan_nfft(min_len)


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
    return channelizer.channelize_parts(
        re, im, num_channels, taps_per_channel=taps_per_channel, shift=shift
    )


def pad_ct(
    sig_re: torch.Tensor, sig_im: torch.Tensor, *, max_lag: int,
    plan: Optional[ct_plan.DetectPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``sig_re/sig_im [..., n]`` zero-padded to ``nfft =
    ct_plan.plan_nfft(n + max_lag)`` (alias-free for ±max_lag), contiguous:
    ``(xr, xi, nfft)``. A detect ``plan`` must be for that nfft."""
    n = sig_re.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < block length {n}")
    nfft = ct_plan.plan_nfft(n + max_lag)
    if plan is not None and plan.nfft != nfft:
        raise ValueError(f"detect plan for nfft {plan.nfft}, but block {n} + max_lag {max_lag} plans {nfft}")
    pad = lambda a: F.pad(a, (0, nfft - n)).contiguous()
    return pad(sig_re), pad(sig_im), nfft


def receiver_spectra_ct(
    sig_re: torch.Tensor, sig_im: torch.Tensor, *, max_lag: int
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Per-receiver CT-order spectra for the pair stage: :func:`pad_ct`,
    then kernel K3 in one launch over all leading rows. Returns ``(fr, fi,
    nfft)`` with ``fr/fi [..., nfft]``.
    """
    xr, xi, nfft = pad_ct(sig_re, sig_im, max_lag=max_lag)
    fr, fi = fft_rows.fft_rows_ct(xr, xi)
    return fr, fi, nfft


def receiver_spectra_ct_detect(
    sig_re: torch.Tensor, sig_im: torch.Tensor, *, max_lag: int, plan: ct_plan.DetectPlan,
    emit_topk: int = 0,
):
    """CT-order spectra, detect partials and per-receiver power maxima from
    one launch of kernel K1 over every row of ``[..., n]``.

    Returns ``((fr, fi, nfft), (seg_score, seg_arg, noise_floor_db),
    row_max)``: spectra ``[..., nfft]``, partials ``[..., nfft/8]`` (with
    ``emit_topk``, K1's ``[..., 128]`` top-K blocks), floor and max linear
    power ``[...]`` (the l2rx gate input).
    """
    xr, xi, n = pad_ct(sig_re, sig_im, max_lag=max_lag, plan=plan)
    batch = xr.shape[:-1]
    fr, fi, score, arg, nf, rmax = fft_detect.fft_detect_rows_ct(
        xr.reshape(-1, n), xi.reshape(-1, n), plan, emit_topk
    )
    s = score.shape[-1]
    return (
        (fr.reshape(*batch, n), fi.reshape(*batch, n), n),
        (score.reshape(*batch, s), arg.reshape(*batch, s), nf.reshape(batch)),
        rmax.reshape(batch),
    )


def flagship_channel_step(
    sig_re: torch.Tensor,
    sig_im: torch.Tensor,
    pair_i,
    pair_j,
    *,
    max_lag: int,
    eps: float,
    plan: ct_plan.DetectPlan,
):
    """Pad, then kernel K8: FFT × detect × GCC (l2rx) per channel, the
    spectra never returned. ``sig_re/sig_im [..., B, n]`` → ``(nfft,
    (seg_score, seg_arg, noise_floor_db), lag_mags [..., P, 2L+1])``."""
    xr, xi, _ = pad_ct(sig_re, sig_im, max_lag=max_lag, plan=plan)
    score, arg, nf, window = channel_step.channel_step_partials(
        xr, xi, pair_i, pair_j, plan, max_lag, eps
    )
    return plan.nfft, (score, arg, nf), window


def ct_power_db(fr: torch.Tensor, fi: torch.Tensor) -> torch.Tensor:
    """Natural-bin-order power spectrum in dB from CT-order spectra: the
    power ``[..., n2, n1]`` transposed, which is the inverse of
    :func:`ct_plan.ct_permutation` (bin k = k2 + n2·k1 sits at m = k2·n1 +
    k1); values are those of an nfft-point zero-padded FFT."""
    n = fr.shape[-1]
    n1, n2 = ct_plan.ct_split(n)
    p = (fr * fr + fi * fi).reshape(*fr.shape[:-1], n2, n1).transpose(-1, -2)
    return 10.0 * torch.log10(p.reshape(*fr.shape[:-1], n) + 1e-24)


def gcc_phat_all_pairs_split_fused(
    sig_re: torch.Tensor,
    sig_im: torch.Tensor,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
    psr_exclude: int = 8,
    spectra: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None,
    row_smax: Optional[torch.Tensor] = None,
) -> gcc_phat.CorrelationPeak:
    """All i<j pairs of ``[..., B, N]`` through kernel K2 on CT-order
    spectra (from :func:`receiver_spectra_ct` or K1, or computed here by
    K3), then the sub-sample peak pick. ``row_smax [..., B]`` enables the
    l2rx gate; the whitening follows :func:`gcc_pair.resolve_gate`."""
    n, b = sig_re.shape[-1], sig_re.shape[-2]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < block length {n}")
    fr, fi, nfft = spectra if spectra is not None else receiver_spectra_ct(sig_re, sig_im, max_lag=max_lag)
    if nfft < n + max_lag or fr.shape[-1] != nfft:
        raise ValueError(
            f"provided spectra (nfft={nfft}, last dim {fr.shape[-1]}) violate the "
            f"alias-free bound for block {n} + max_lag {max_lag}"
        )
    batch = fr.shape[:-2]
    i_idx, j_idx = gcc_phat.pair_indices(b)
    mags = gcc_pair.gcc_pair_lag_mags(
        fr.reshape(-1, b, nfft), fi.reshape(-1, b, nfft),
        None if row_smax is None else row_smax.reshape(-1, b),
        i_idx, j_idx, max_lag=max_lag, eps=eps, weighting=weighting,
    )
    return gcc_phat.peaks_from_lag_mags(
        mags.reshape(*batch, len(i_idx), 2 * max_lag + 1),
        sample_rate_hz=sample_rate_hz, max_lag=max_lag, psr_exclude=psr_exclude,
    )


def power_spectrum_db_split(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``10·log10(|FFT|² + 1e-24)`` over the last axis, natural bin order."""
    fre, fim = fft_ops.fft_re_im(re, im)
    return 10.0 * torch.log10(fre * fre + fim * fim + 1e-24)


# the inverse by the conjugation identity, shared with the complex path
ifft_re_im = fft_ops.ifft_re_im


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


# |r| of every pair from natural-order spectra: the one weighting body of
# the complex and the split GCC (R = X_i·conj(X_j), the phat/scot/roth/cc
# gate, the inverse transform, the lag window)
gcc_lag_mags_split = gcc_phat.pair_lag_mags


def cross_correlate_split(
    xre: torch.Tensor, xim: torch.Tensor, yre: torch.Tensor, yim: torch.Tensor,
    *,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split-complex :func:`.gcc_phat.cross_correlate`: ``(re, im)`` of the
    GCC of x and y ``[..., N]`` at lags −max_lag..+max_lag, both padded to
    ``friendly_fft_len(N + max_lag)``."""
    n = xre.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < block length {n}")
    nfft = fft_ops.friendly_fft_len(n + max_lag)
    pad = lambda a: F.pad(a.to(torch.float32), (0, nfft - n))
    xfr, xfi = fft_ops.fft_re_im(pad(xre), pad(xim))
    yfr, yfi = fft_ops.fft_re_im(pad(yre), pad(yim))
    return gcc_phat.weighted_lag_window(xfr, xfi, yfr, yfi, max_lag=max_lag, weighting=weighting, eps=eps)


def gcc_phat_split(
    xre, xim, yre, yim,
    *,
    sample_rate_hz: float,
    max_lag: int,
    weighting: str = "phat",
    eps: float = 0.05,
    psr_exclude: int = 8,
) -> CorrelationPeakSC:
    """Split-complex :func:`.gcc_phat.gcc_phat`."""
    cre, cim = cross_correlate_split(xre, xim, yre, yim, max_lag=max_lag, weighting=weighting, eps=eps)
    return gcc_phat.peaks_from_lag_mags(
        torch.sqrt(cre * cre + cim * cim),
        sample_rate_hz=sample_rate_hz, max_lag=max_lag, psr_exclude=psr_exclude,
    )


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
    pair_i, pair_j = gcc_phat.pair_index_tensors(sig_re.shape[-2], fr.device)
    mags = gcc_lag_mags_split(fr, fi, pair_i, pair_j, max_lag=max_lag, weighting=weighting, eps=eps)
    return gcc_phat.peaks_from_lag_mags(
        mags, sample_rate_hz=sample_rate_hz, max_lag=max_lag, psr_exclude=psr_exclude
    )
