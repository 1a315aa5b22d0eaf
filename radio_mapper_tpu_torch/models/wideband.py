"""Wideband channelized TDOA (BASELINE config 4) on one device.

Port of ``radio_mapper_tpu/models/wideband.py`` (``WidebandConfig``,
``WidebandOutput``, ``WidebandTDOAPipeline``). Where
``split_complex.gcc_fused_enabled(sub_block + max_lag, weighting)`` holds
(the default for "phat" and "cc"), the pair stage is the fused one the
reference runs on the TPU: "phat" under the gate of
``gcc_pair.set_phat_gate`` (l2rx by default, with s2 from per-receiver
maxima; l2 or l1 from each pair's own maximum) or "cc" (not whitened):

    re/im [B, N_wide] ─ PFB channelize, branch DFT over M   ops.split_complex
      → [M, B, n_sub] → zero-pad to nfft = plan_nfft(n_sub + max_lag)
      → K3: CT-order FFT of all M·B rows, one launch        ops.cuda.fft_rows
      → s2 = rmax_i·rmax_j per pair (rmax = max_k |X|²;    ops.safe.pair_select
            the l2rx gate only)
      → K5: pair gather × whiten × inverse × lag window     ops.cuda.gcc_pair
            for all M subchannels in one launch
        (or, when the reference's gate says no, per subchannel:
         index gather of 4 × [P, nfft] rows → K6)
      → peak pick + PSR weights + LM solve, batched over M  ops.gcc_phat, solver

Otherwise (``set_gcc_fused("off")``, or "scot" and "roth") it is the
reference's natural-grid fallback, per subchannel: zero-pad to
``fft.friendly_fft_len(sub_block + max_lag)``, the natural-order forward
(``fft.fft_re_im``), the pair gather by index, then
``gcc_phat.weighted_lag_window``: R = X·conj(Y), the textbook
``|R| + eps·max|R|`` whitening for "phat" only (the other weightings run
unwhitened, as in the reference), the inverse by conjugation and the lag
window. At config 4 that nfft is 4320, which the matmul four-step takes:
no kernel, as in the reference.

The reference scans subchannels only to bound TPU memory; here the K5
route holds the [M, B, nfft] spectra (42 MB at full width) and runs every
subchannel in one launch. The K6 route keeps the reference's loop: its
gathered rows are 165 MB per subchannel.

:func:`build_wideband_sharded_step` runs the same step over a mesh of
ranks: the channelizer replicated, the subchannels split over the "sub"
axis, each rank's pair stage and tail on its M/n subchannels, the outputs
gathered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from radio_mapper_tpu_torch import solver
from radio_mapper_tpu_torch.ops import ct_plan, safe
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops import gcc_phat as gcc_ops
from radio_mapper_tpu_torch.ops import split_complex as sc_ops
from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.parallel import collectives
from radio_mapper_tpu_torch.parallel import mesh as mesh_lib

StageHook = Optional[Callable[[str], None]]


@dataclasses.dataclass(frozen=True)
class WidebandConfig:
    """Static configuration (same fields and defaults as the JAX package's:
    the default is the full config-4 width)."""

    num_buoys: int = 64
    wide_rate_hz: float = 10_000_000.0
    num_subchannels: int = 16
    taps_per_channel: int = 8
    sub_block: int = 4096  # per-subchannel samples per step
    max_lag: int = 128  # at the subchannel rate
    weighting: str = "phat"
    gcc_eps: float = 0.05
    solver_iterations: int = 15
    psr_floor: float = 1.1
    psr_scale: float = 2.0

    @classmethod
    def from_dict(cls, d: dict) -> "WidebandConfig":
        """Carry a JAX config across: ``from_dict(dataclasses.asdict(cfg))``."""
        return cls(**d)

    @property
    def num_pairs(self) -> int:
        return self.num_buoys * (self.num_buoys - 1) // 2

    @property
    def wide_block(self) -> int:
        """Wideband samples per buoy per step: the PFB eats T−1 frames of
        filter history, so M·(n_sub + T − 1) input samples yield exactly
        n_sub output frames per subchannel."""
        return self.num_subchannels * (self.sub_block + self.taps_per_channel - 1)

    @property
    def sub_rate_hz(self) -> float:
        return self.wide_rate_hz / self.num_subchannels

    @property
    def nfft(self) -> int:
        """The fused pair stage's FFT length (the fallback's is
        ``fft.friendly_fft_len(sub_block + max_lag)``)."""
        return ct_plan.plan_nfft(self.sub_block + self.max_lag)

    def validate(self) -> "WidebandConfig":
        if self.max_lag >= self.sub_block:
            raise ValueError("max_lag must be < sub_block")
        if self.num_buoys < 2:
            raise ValueError("need at least 2 receivers")
        if self.weighting not in gcc_ops.WEIGHTINGS:
            raise ValueError(f"unknown weighting {self.weighting!r}; expected one of {gcc_ops.WEIGHTINGS}")
        return self


class WidebandOutput(NamedTuple):
    fixes_enu: torch.Tensor  # [M, 3] per-subchannel position
    cost: torch.Tensor  # [M]
    lags: torch.Tensor  # [M, P] pair lags (subchannel samples)
    weights: torch.Tensor  # [M, P]
    channel_offset_hz: np.ndarray  # [M] static subchannel centers


class WidebandTDOAPipeline:
    """Config-4 pipeline for a fixed configuration on one device.

    Inputs must already lie on ``device`` (the card by default; CPU callers
    pass ``device="cpu"``). On a CUDA device K3 and K5 (or K6) run the
    hand-written kernels; on the CPU they run their plain PyTorch versions.
    The route is fixed when the pipeline is built, from the knob
    ``split_complex.set_gcc_fused`` and the weighting (``use_fused``), as
    the reference fixes it.
    """

    def __init__(self, config: WidebandConfig, *, device: torch.device | str = "cuda"):
        self.config = config.validate()
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        i_idx, j_idx = gcc_ops.pair_indices(config.num_buoys)
        self.pair_i_np, self.pair_j_np = i_idx, j_idx
        self.pair_i = torch.as_tensor(i_idx, dtype=torch.int64, device=self.device)
        self.pair_j = torch.as_tensor(j_idx, dtype=torch.int64, device=self.device)
        self.use_fused = sc_ops.gcc_fused_enabled(config.sub_block + config.max_lag, config.weighting)
        self.pair_nfft = (config.nfft if self.use_fused
                          else fft_ops.friendly_fft_len(config.sub_block + config.max_lag))

    def _on_device(self, *xs: torch.Tensor) -> None:
        for x in xs:
            if x.device != self.device:
                raise ValueError(f"input on {x.device}, pipeline on {self.device}")

    # -- stages ---------------------------------------------------------

    def _pair_stage(
        self, cre: torch.Tensor, cim: torch.Tensor, *, on_stage: StageHook = None
    ) -> torch.Tensor:
        """Subchannel signals ``[..., B, n_sub]`` → lag windows
        ``[..., P, 2L+1]`` (the reference's per-subchannel ``_pair_stage``,
        here over any leading axes at once).

        ``on_stage`` is called after "fft", "s2" and "pair" (on the
        fallback, which has no gate scales, "s2" marks an empty span).
        """
        c = self.config
        mark = on_stage or (lambda _name: None)
        lag = c.max_lag
        if not self.use_fused:
            return self._natural_pair_stage(cre, cim, mark)
        fr, fi, nfft = sc_ops.receiver_spectra_ct(cre, cim, max_lag=lag)  # K3
        mark("fft")
        # Per-pair l2rx gate scales from per-receiver maxima: one [.., B, nfft]
        # reduction instead of a [.., P, nfft] one in the pair kernel.
        s2 = None
        if c.weighting == "phat" and gcc_pair.phat_gate() == "l2rx":
            rmax = (fr * fr + fi * fi).amax(dim=-1)  # [..., B]
            s2 = safe.pair_select(rmax, self.pair_i, axis=-1) * safe.pair_select(
                rmax, self.pair_j, axis=-1
            )  # [..., P]
        mark("s2")
        if gcc_pair.onehot_pairs_enabled(c.num_buoys, nfft):
            mags = gcc_pair.gcc_pairs_onehot_lag_mags(
                fr, fi, self.pair_i_np, self.pair_j_np,
                max_lag=lag, eps=c.gcc_eps, weighting=c.weighting, s2=s2,
            )
        else:
            lead = fr.shape[:-2]
            b, p = c.num_buoys, c.num_pairs
            frs, fis = fr.reshape(-1, b, nfft), fi.reshape(-1, b, nfft)
            s2s = [None] * frs.shape[0] if s2 is None else s2.reshape(-1, p)
            mags = torch.stack([
                self._rows_pair_stage(frs[k], fis[k], s2s[k]) for k in range(frs.shape[0])
            ]).reshape(*lead, p, 2 * lag + 1)
        mark("pair")
        return mags

    def _natural_pair_stage(self, cre, cim, mark) -> torch.Tensor:
        """The reference's fallback pair stage (``_pair_stage`` when not
        ``_use_fused``) over any leading axes, one subchannel at a time as
        the reference's scan runs it: natural-order spectra at the 5-smooth
        nfft, the pair gather, then the GCC body of ``ops.gcc_phat``
        (R = X·conj(Y), whitened for "phat" only, the inverse by
        conjugation, the ±max_lag window) and |r|."""
        c = self.config
        nfft = self.pair_nfft
        pad = lambda a: F.pad(a.to(torch.float32), (0, nfft - c.sub_block))
        fr, fi = fft_ops.fft_re_im(pad(cre), pad(cim))
        mark("fft")
        mark("s2")
        lead = fr.shape[:-2]
        frs, fis = fr.reshape(-1, c.num_buoys, nfft), fi.reshape(-1, c.num_buoys, nfft)
        weighting = "phat" if c.weighting == "phat" else "cc"  # the reference whitens "phat" only here
        mags = [
            gcc_ops.pair_lag_mags(xr, xi, self.pair_i, self.pair_j, max_lag=c.max_lag,
                                  weighting=weighting, eps=c.gcc_eps)
            for xr, xi in zip(frs, fis)
        ]
        mark("pair")
        return torch.stack(mags).reshape(*lead, c.num_pairs, 2 * c.max_lag + 1)

    def _rows_pair_stage(self, fr, fi, s2):
        """One subchannel on the K6 route: gather 4 × [P, nfft] rows by
        index, then the row-aligned pair kernel."""
        c = self.config
        sel = lambda x, idx: safe.pair_select(x, idx, axis=-2)
        return gcc_pair.gcc_rows_lag_mags(
            sel(fr, self.pair_i), sel(fi, self.pair_i), sel(fr, self.pair_j), sel(fi, self.pair_j),
            max_lag=c.max_lag, eps=c.gcc_eps, weighting=c.weighting, s2=s2,
        )

    def _batched_tail(
        self, mags: torch.Tensor, anchors_enu: torch.Tensor, *, on_stage: StageHook = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Peak pick + PSR weights + LM solve, batched over the leading
        subchannel axis: ``mags [M, P, 2L+1]`` → (fixes [M, 3], cost [M],
        lags [M, P], weights [M, P]). ``on_stage`` is called after
        "lag_peaks" and "solve"."""
        c = self.config
        mark = on_stage or (lambda _name: None)
        pk = gcc_ops.peaks_from_lag_mags(mags, sample_rate_hz=c.sub_rate_hz, max_lag=c.max_lag)
        mark("lag_peaks")
        weights = torch.clamp((pk.psr - c.psr_floor) / c.psr_scale, 0.0, 1.0) + 1e-3
        dd = solver.tau_to_distance_difference(pk.tau_s)
        anchors_b = anchors_enu.expand(*mags.shape[:-2], *anchors_enu.shape)
        res = solver.solve_tdoa_impl(
            anchors_b, self.pair_i, self.pair_j, dd, weights, iterations=c.solver_iterations,
        )
        mark("solve")
        return res.position_enu, res.cost, pk.lag_samples, weights

    # -- full step --------------------------------------------------------

    def step_split(
        self, re: torch.Tensor, im: torch.Tensor, anchors_enu: torch.Tensor,
        *, on_stage: StageHook = None,
    ) -> WidebandOutput:
        """Full config-4 step on float32 ``re/im [B, wide_block]`` and
        anchors ``[B, 3]``.

        ``on_stage(name)``, when given, is called after each stage
        ("channelize", "fft", "s2", "pair", "lag_peaks", "solve") — a hook
        for per-stage timing; it changes nothing else.
        """
        c = self.config
        mark = on_stage or (lambda _name: None)
        self._on_device(re, im, anchors_enu)
        shape = (c.num_buoys, c.wide_block)
        if re.shape != shape or im.shape != shape:
            raise ValueError(f"expected wideband block {shape}, got {tuple(re.shape)}, {tuple(im.shape)}")
        cre, cim = sc_ops.channelize_split(
            re.to(torch.float32), im.to(torch.float32), c.num_subchannels,
            sample_rate_hz=c.wide_rate_hz,
            taps_per_channel=c.taps_per_channel,
            shift=False,  # subchannel order = FFT bin order; offsets map below
        )  # [B, M, n_sub]
        cre, cim = cre.movedim(-2, 0), cim.movedim(-2, 0)  # [M, B, n_sub]
        mark("channelize")
        mags = self._pair_stage(cre, cim, on_stage=on_stage)  # [M, P, 2L+1]
        fixes, cost, lags, weights = self._batched_tail(
            mags, anchors_enu.to(torch.float32), on_stage=on_stage
        )
        return WidebandOutput(
            fixes_enu=fixes,
            cost=cost,
            lags=lags,
            weights=weights,
            channel_offset_hz=np.fft.fftfreq(c.num_subchannels, d=1.0 / c.wide_rate_hz),
        )

    def example_inputs(self, *, seed: int = 0):
        """Random ``(re, im, anchors)`` on the pipeline's device, drawn
        from numpy ``default_rng(seed)`` in the JAX package's order, so
        both packages see the same values."""
        c = self.config
        rng = np.random.default_rng(seed)
        re = rng.normal(size=(c.num_buoys, c.wide_block)).astype(np.float32)
        im = rng.normal(size=(c.num_buoys, c.wide_block)).astype(np.float32)
        anchors = rng.normal(scale=8_000.0, size=(c.num_buoys, 3)).astype(np.float32)
        anchors[:, 2] = 0.0
        to = lambda a: torch.from_numpy(a).to(self.device)
        return to(re), to(im), to(anchors)


def build_wideband_sharded_step(mesh, config: WidebandConfig, *, axis: str = "sub"):
    """Config 4 across a mesh of ranks: SUBCHANNELS split over ``axis``.

    Port of the reference's ``build_wideband_sharded_step``. Every rank
    channelizes the whole block (replicated: ~2% of one subchannel's pair
    stage), keeps its M/n subchannels, runs :meth:`WidebandTDOAPipeline._pair_stage`
    (K3, then K5 or K6; or the natural-grid fallback where the route knob
    says so) and :meth:`WidebandTDOAPipeline._batched_tail` on
    them (no collective in the hot path), and all_gathers the outputs over
    ``axis``.

    Returns ``(step, in_specs)`` with ``step(re, im, anchors) ->
    WidebandOutput`` on every rank, the inputs replicated (whole on every
    rank, on its device).
    """
    cfg = config.validate()
    ax = mesh_lib.axis(mesh, axis)
    if cfg.num_subchannels % ax.size:
        raise ValueError(
            f"num_subchannels {cfg.num_subchannels} must divide over {ax.size} shards"
        )
    pipe = WidebandTDOAPipeline(cfg, device=mesh_lib.rank_device(mesh))
    m_loc = cfg.num_subchannels // ax.size
    mine = slice(ax.index * m_loc, (ax.index + 1) * m_loc)

    def step(re: torch.Tensor, im: torch.Tensor, anchors: torch.Tensor) -> WidebandOutput:
        c = cfg
        pipe._on_device(re, im, anchors)
        cre, cim = sc_ops.channelize_split(
            re.to(torch.float32), im.to(torch.float32), c.num_subchannels,
            sample_rate_hz=c.wide_rate_hz,
            taps_per_channel=c.taps_per_channel,
            shift=False,
        )  # [B, M, n_sub]
        cre, cim = cre.movedim(-2, 0)[mine], cim.movedim(-2, 0)[mine]  # [M/n, B, n_sub]
        mags = pipe._pair_stage(cre, cim)
        local = pipe._batched_tail(mags, anchors.to(torch.float32))
        fixes, cost, lags, weights = (collectives.all_gather(x, ax, dim=0) for x in local)
        return WidebandOutput(
            fixes_enu=fixes, cost=cost, lags=lags, weights=weights,
            channel_offset_hz=np.fft.fftfreq(c.num_subchannels, d=1.0 / c.wide_rate_hz),
        )

    repl = mesh_lib.replicated()
    return step, (repl, repl, repl)
