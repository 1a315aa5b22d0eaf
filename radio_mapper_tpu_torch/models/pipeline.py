"""The flagship end-to-end TDOA pipeline: decode → detect → correlate → solve.

Port of ``radio_mapper_tpu/models/pipeline.py``. Single dwell
(``correlation_dwells == 1``): the reference's route table, in its order
and under its knobs. The default route (the TPU's):

    uint8 IQ [..., B, 2N] → (re, im) f32                 ops.iq
      → zero-pad to nfft = ct_plan.plan_nfft(N + max_lag)
      → K1: CT-order FFT + detect partials + row max     ops.cuda.fft_detect
      → top-K tail                                       ops.detect
      → K2: all-pairs whiten × inverse DFT × lag window  ops.cuda.gcc_pair
      → argmax + parabolic τ + PSR                       ops.gcc_phat
      → pair weights → LM solve + GLS ellipse            solver

and the others, each ending in the same tail:

    mega        channel_step.set_mega_fused("on"), "phat", B ≤ 16:
                K8: K1 and K2 (l2rx) of each channel in one launch
                → top-K tail + lag peaks                 ops.cuda.channel_step
    two-kernel  detect.set_fused_fft_detect("off"):
                K3 spectra → K4 partials → top-K tail → K2 (no row maxima:
                the l2rx gate runs as l2)                ops.cuda.fft_rows, detect_ct
    unfused     detect.set_fused_detect("off") or noise_floor_stride ≠ 8:
    detect      K3 spectra → ct_power_db → natural detect_peaks → K2 (l2)
    unfused     split_complex.set_gcc_fused("off"), or "scot"/"roth":
    GCC         natural-order spectra (ops.fft; even bins = the N-point
                FFT when nfft = 2N exactly) → detect_peaks → split GCC

"cc" runs the fused chain unwhitened; ``gcc_pair.set_phat_gate`` picks
K2's PHAT gate (l2rx, l2, l1).

The complex-IQ step (``step``/``step_uint8``, complex64 ``[..., B, K·N]``)
is the reference's own: the power spectrum of each dwell (``ops.spectral``;
K7 at N = 16384, 32768, 65536 on the card) → natural-order
``detect_peaks`` (the dwell-averaged PSD when K > 1) → all-pairs GCC of
the whole capture at the 5-smooth nfft on the capture's float32 planes
(``ops.gcc_phat``, in chunks of channels: the multi-dwell route's pair
stage) → the same tail.

Narrowband multi-dwell (``correlation_dwells = K > 1``, inputs
``[..., B, K·N]``): the dwell-averaged PSD on the N-point grid (kernel K7
at N = 16384, 32768, 65536 on the card, :mod:`.ops.fft`) → natural-order
``detect_peaks`` → one coherent all-pairs GCC over the K·N capture at the
5-smooth nfft, in chunks of channels: on the card at the lengths
:func:`.ops.cuda.pair_fft.route` covers (nfft 135000, K = 8 dwells of
16384), kernel K9 (the receivers' spectra) → its max pass → K10 (whitening
and the inverse at the window's lags only); elsewhere the matmul four-step
(:mod:`.ops.split_complex`) → the same tail; ``solver_starts > 1`` solves
from several starts on either route.

All leading dims are batch dims (``[channels, B, N]``). PyTorch runs
eagerly, so the "step" is a plain call; the K-block scan is a loop over
the leading axis, so the working set stays one block.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from radio_mapper_tpu_torch import constants, solver
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops import detect as detect_ops
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops import gcc_phat as gcc_ops
from radio_mapper_tpu_torch.ops import iq as iq_ops
from radio_mapper_tpu_torch.ops import spectral
from radio_mapper_tpu_torch.ops import split_complex as sc_ops
from radio_mapper_tpu_torch.ops.cuda import channel_step, detect_ct, pair_fft
from radio_mapper_tpu_torch.utils import spans

# The natural-order pair stage (the complex step's and the multi-dwell
# route's) runs over channels in chunks whose [P, nfft]
# float32 planes hold at most this many bytes: the matmul four-step keeps
# about a dozen such planes alive, so at the full narrowband width (128
# channels × 28 pairs × nfft 135000, 1.9 GB a plane) device memory stays
# at a few GiB. Channels are independent: the chunking changes no value
# beyond the rounding of a product's blocking.
PAIR_PLANE_BYTES = 512 << 20
# On the K9 → K10 route a chunk holds only its receivers' spectra (8 bytes
# a bin, in place), so it is cut by those: a narrowband dispatch of two
# captures × 128 channels × 8 buoys (2.2 GB at nfft 135000) is one chunk.
PAIR_SPECTRA_BYTES = 4 << 30


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static pipeline configuration (same fields as the JAX package's)."""

    num_buoys: int = 4
    block_len: int = 16_384
    sample_rate_hz: float = constants.DEFAULT_SAMPLE_RATE_HZ
    max_lag: int = 512
    max_peaks: int = 8
    weighting: str = "phat"
    gcc_eps: float = 0.05
    detection_threshold_db: float = constants.DEFAULT_DETECTION_THRESHOLD_DBM
    power_offset_db: float = 0.0
    solve_2d: bool = True
    solver_iterations: int = 40
    solver_starts: int = 1
    noise_floor_stride: int = 8
    psr_floor: float = 1.2
    psr_scale: float = 2.0
    correlation_dwells: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        """Carry a JAX config across: ``from_dict(dataclasses.asdict(cfg))``."""
        return cls(**d)

    def validate(self) -> "PipelineConfig":
        if self.max_lag >= self.block_len:
            raise ValueError("max_lag must be smaller than block_len")
        if self.num_buoys < 2:
            raise ValueError("need at least 2 receivers")
        if self.correlation_dwells < 1:
            raise ValueError("correlation_dwells must be >= 1")
        if self.weighting not in sc_ops.WEIGHTINGS:
            raise ValueError(f"unknown weighting {self.weighting!r}")
        if self.noise_floor_stride < 1:
            raise ValueError("noise_floor_stride must be >= 1")
        return self

    @property
    def num_pairs(self) -> int:
        return self.num_buoys * (self.num_buoys - 1) // 2

    @property
    def nfft(self) -> int:
        """The single-dwell route's CT-order FFT length."""
        return ct_plan.plan_nfft(self.block_len + self.max_lag)


class PipelineOutput(NamedTuple):
    # per-buoy detections [..., B, K]; bin_index on the nfft grid (single
    # dwell) or the block_len grid (multi-dwell) — see detect_ops.PeakSet
    peaks: detect_ops.PeakSet
    correlation: gcc_ops.CorrelationPeak  # per-pair TDOA [..., P]
    pair_weights: torch.Tensor  # [..., P]
    fix: solver.SolveResult  # [...]-batched position solution
    buoy_confidence: torch.Tensor  # [..., B] strongest-peak confidence


StageHook = Optional[Callable[[str], None]]


class TDOAPipeline:
    """The flagship step for a fixed configuration on one device.

    Inputs must already lie on ``device`` (the card by default; CPU callers
    pass ``device="cpu"``). On a CUDA device the kernels of the route (K1
    and K2, K8, K3 with K4 and K2, or K7) run by hand-written CUDA; on the
    CPU their plain PyTorch versions run.
    """

    def __init__(self, config: PipelineConfig, *, device: torch.device | str = "cuda"):
        self.config = config.validate()
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        i_idx, j_idx = gcc_ops.pair_indices(config.num_buoys)
        self.pair_i_np, self.pair_j_np = i_idx, j_idx
        self.pair_i = torch.as_tensor(i_idx, dtype=torch.int64, device=self.device)
        self.pair_j = torch.as_tensor(j_idx, dtype=torch.int64, device=self.device)
        # The fused detect's parameters on the CT grid (the reference's
        # _full_detect_kwargs), where the fused detect covers the config.
        c = self.config
        self.plan = None
        if c.correlation_dwells == 1 and detect_ct.supported(
            c.nfft, min_distance_bins=constants.DEFAULT_PEAK_MIN_DISTANCE_BINS,
            noise_floor_stride=ct_plan.SEGMENT,
        ):
            self.plan = ct_plan.detect_plan(
                c.nfft,
                sample_rate_hz=c.sample_rate_hz,
                threshold_db=c.detection_threshold_db,
                min_distance_bins=constants.DEFAULT_PEAK_MIN_DISTANCE_BINS,
                dc_notch_hz=constants.DEFAULT_DC_NOTCH_HZ,
                confidence_floor=constants.DEFAULT_CONFIDENCE_FLOOR,
                snr_fullscale_db=constants.DEFAULT_SNR_FULLSCALE_DB,
                power_offset_db=c.power_offset_db,
            )

    def _on_device(self, *xs: torch.Tensor) -> None:
        for x in xs:
            if x.device != self.device:
                raise ValueError(f"input on {x.device}, pipeline on {self.device}")

    # -- stages ---------------------------------------------------------

    def detect(self, iq: torch.Tensor) -> detect_ops.PeakSet:
        """Peaks of complex ``iq [..., N]`` (the reference's ``detect``)."""
        c = self.config
        return detect_ops.detect_signals(
            iq,
            sample_rate_hz=c.sample_rate_hz,
            max_peaks=c.max_peaks,
            power_offset_db=c.power_offset_db,
            threshold_db=c.detection_threshold_db,
            noise_floor_stride=c.noise_floor_stride,
        )

    def correlate(self, iq: torch.Tensor, *, on_stage: StageHook = None) -> gcc_ops.CorrelationPeak:
        """All-pairs GCC of complex ``iq [..., B, L]`` (the reference's
        ``correlate``: ``gcc_phat_all_pairs`` at ``friendly_fft_len(L +
        max_lag)``), on its float32 planes by :meth:`_pair_stage`."""
        return self._pair_stage(iq.real, iq.imag, on_stage or (lambda _name: None))

    def _pair_stage(self, re: torch.Tensor, im: torch.Tensor, mark) -> gcc_ops.CorrelationPeak:
        """All-pairs GCC of ``(re, im) [..., B, L]`` at ``friendly_fft_len(L
        + max_lag)``, in chunks of the flattened leading dims: K9 → max pass
        → K10 where :func:`pair_fft.route` says so (chunks of
        ``PAIR_SPECTRA_BYTES`` of spectra), else the matmul four-step
        (float32 ``[P, nfft]`` planes under ``PAIR_PLANE_BYTES``); each
        chunk marks "spectra", "pair_corr" and "lag_peaks"."""
        c = self.config
        batch = re.shape[:-2]
        length = re.shape[-1]
        flat = lambda a: a.reshape(-1, c.num_buoys, length)
        nfft = fft_ops.friendly_fft_len(length + c.max_lag)
        kernels = pair_fft.route(
            nfft, re.device, c.weighting, max_lag=c.max_lag, num_receivers=c.num_buoys
        ) == "kernels"
        if kernels:
            chunk = max(1, PAIR_SPECTRA_BYTES // (8 * c.num_buoys * nfft))
        else:
            chunk = max(1, PAIR_PLANE_BYTES // (4 * c.num_pairs * nfft))
        parts = []
        for cre, cim in zip(flat(re).split(chunk), flat(im).split(chunk)):
            if kernels:
                spec = pair_fft.receiver_spectra(cre.reshape(-1, length), cim.reshape(-1, length), nfft)
                mark("spectra")
                mags = pair_fft.lag_mags(spec, c.num_buoys, max_lag=c.max_lag, eps=c.gcc_eps)
                del spec
            else:
                fr, fi, _ = sc_ops.receiver_spectra_split(cre, cim, max_lag=c.max_lag)
                mark("spectra")
                mags = gcc_ops.pair_lag_mags(
                    fr, fi, self.pair_i, self.pair_j,
                    max_lag=c.max_lag, weighting=c.weighting, eps=c.gcc_eps,
                )
                del fr, fi
            mark("pair_corr")
            parts.append(gcc_ops.peaks_from_lag_mags(
                mags, sample_rate_hz=c.sample_rate_hz, max_lag=c.max_lag
            ))
            mark("lag_peaks")
        return gcc_ops.CorrelationPeak(
            *(torch.cat(f).reshape(*batch, c.num_pairs) for f in zip(*parts))
        )

    def solve(
        self, anchors_enu: torch.Tensor, corr: gcc_ops.CorrelationPeak, weights: torch.Tensor
    ) -> solver.SolveResult:
        """The LM solve of one set of pair delays (multi-start when
        ``solver_starts > 1``)."""
        c = self.config
        solve = solver.solve_tdoa
        if c.solver_starts > 1:
            solve = functools.partial(solver.solve_tdoa_multistart, num_starts=c.solver_starts)
        return solve(
            anchors_enu,
            self.pair_i,
            self.pair_j,
            solver.tau_to_distance_difference(corr.tau_s),
            weights,
            solve_2d=c.solve_2d,
            iterations=c.solver_iterations,
        )

    def pair_weights(
        self, peaks: detect_ops.PeakSet, corr: gcc_ops.CorrelationPeak
    ) -> torch.Tensor:
        """min(conf_i, conf_j) · PSR quality in [0.1, 1]."""
        c = self.config
        buoy_conf = torch.where(peaks.valid, peaks.confidence, 0.0).amax(dim=-1)  # [..., B]
        conf_i = buoy_conf.index_select(-1, self.pair_i)
        conf_j = buoy_conf.index_select(-1, self.pair_j)
        psr_q = 0.1 + 0.9 * torch.clamp((corr.psr - c.psr_floor) / c.psr_scale, 0.0, 1.0)
        return torch.minimum(conf_i, conf_j) * psr_q

    def _finish(self, peaks, corr: gcc_ops.CorrelationPeak, anchors_enu) -> PipelineOutput:
        """Shared tail: weights → solve → output."""
        weights = self.pair_weights(peaks, corr)
        fix = self.solve(anchors_enu, corr, weights)
        buoy_conf = torch.where(peaks.valid, peaks.confidence, 0.0).amax(dim=-1)
        return PipelineOutput(
            peaks=peaks,
            correlation=corr,
            pair_weights=weights,
            fix=fix,
            buoy_confidence=buoy_conf,
        )

    # -- full steps -----------------------------------------------------

    @spans.entry
    def step(
        self, iq: torch.Tensor, anchors_enu: torch.Tensor, *, on_stage: StageHook = None
    ) -> PipelineOutput:
        """Full pipeline on complex64 ``iq [..., B, K·N]`` (K =
        ``correlation_dwells``) and anchors ``[..., B, 3]``: the reference's
        ``step``. Detection reads each dwell's power spectrum ("psd"; the
        dwell-averaged PSD on the N-point grid when K > 1), then
        ``detect_peaks`` ("detect"); the pair stage correlates the whole
        capture (:meth:`correlate`: "spectra", "pair_corr", "lag_peaks" per
        chunk of channels); then "solve". ``on_stage`` marks change no value.
        """
        c = self.config
        mark = on_stage or (lambda _name: None)
        self._on_device(iq, anchors_enu)
        k, n = c.correlation_dwells, c.block_len
        if not iq.is_complex() or iq.shape[-2:] != (c.num_buoys, k * n):
            raise ValueError(
                f"need complex iq [..., {c.num_buoys}, {k * n}], got {iq.dtype} {tuple(iq.shape)}"
            )
        iq = iq.to(torch.complex64)
        if k > 1:
            dwell_db = spectral.power_spectrum_db(iq.reshape(*iq.shape[:-1], k, n))  # [..., B, K, N]
            power_db = 10.0 * torch.log10((10.0 ** (dwell_db / 10.0)).mean(dim=-2) + 1e-30)
            del dwell_db
        else:
            power_db = spectral.power_spectrum_db(iq)
        power_db = power_db + c.power_offset_db
        mark("psd")
        peaks = self._detect_natural(power_db)
        del power_db
        mark("detect")
        corr = self.correlate(iq, on_stage=mark)
        return self._solve_marked(peaks, corr, anchors_enu, mark)

    @spans.entry
    def step_uint8(
        self, raw: torch.Tensor, anchors_enu: torch.Tensor, *, on_stage: StageHook = None
    ) -> PipelineOutput:
        """:meth:`step` from raw interleaved uint8 bytes ``[..., B, 2·K·N]``
        (decoded to complex64: "decode")."""
        self._on_device(raw)
        iq = iq_ops.decode_uint8_iq(raw)
        if on_stage is not None:
            on_stage("decode")
        return self.step(iq, anchors_enu, on_stage=on_stage)

    @spans.entry
    def step_split(
        self, re: torch.Tensor, im: torch.Tensor, anchors_enu: torch.Tensor,
        *, on_stage: StageHook = None,
    ) -> PipelineOutput:
        """Full pipeline on float32 ``(re, im)`` ``[..., B, K·N]`` (K =
        ``correlation_dwells``, N = ``block_len``) and anchors ``[..., B, 3]``.

        ``on_stage(name)``, when given, is called after each stage — a hook
        for per-stage timing that also turns on the step's spans
        (:mod:`..utils.spans`); it changes no value. Single dwell, by
        route (the first stage includes the zero-padding, "gcc_pair" the
        lag peak pick): default "fft_detect", "peaks", "gcc_pair",
        "solve"; mega "channel_step", "peaks", "lag_peaks", "solve";
        two-kernel and unfused detect "spectra", "detect" (K4 and the
        top-K tail, or the natural-order detect), "gcc_pair", "solve";
        unfused GCC "spectra", "detect", "pair_corr", "solve". Multi-dwell: "psd",
        "detect", then "spectra", "pair_corr", "lag_peaks" once per chunk
        of channels, then "solve".
        """
        c = self.config
        mark = on_stage or (lambda _name: None)
        self._on_device(re, im, anchors_enu)
        length = c.correlation_dwells * c.block_len
        if re.shape != im.shape or re.shape[-2:] != (c.num_buoys, length):
            raise ValueError(
                f"need re/im [..., {c.num_buoys}, {length}], got {tuple(re.shape)}"
            )
        if c.correlation_dwells > 1:
            return self._step_split_multidwell(re, im, anchors_enu, mark)
        re, im = re.to(torch.float32), im.to(torch.float32)
        n = c.block_len
        if not sc_ops.gcc_fused_enabled(n + c.max_lag, c.weighting):
            return self._step_split_unfused(re, im, anchors_enu, mark)

        nfft = sc_ops.planned_ct_nfft(n + c.max_lag)
        routing = dict(
            min_distance_bins=constants.DEFAULT_PEAK_MIN_DISTANCE_BINS,
            noise_floor_stride=c.noise_floor_stride,
        )
        fused_detect = detect_ops.fused_detect_enabled(nfft, **routing)
        combined = fused_detect and detect_ops.fused_fft_detect_enabled(nfft, **routing)
        tail = dict(sample_rate_hz=c.sample_rate_hz, max_peaks=c.max_peaks,
                    power_offset_db=c.power_offset_db)
        if combined and channel_step.supported(nfft, c.num_buoys, weighting=c.weighting, **routing):
            # FFT, detect and the pair stage of every channel in one launch
            nfft_m, partials, window = sc_ops.flagship_channel_step(
                re, im, self.pair_i_np, self.pair_j_np, max_lag=c.max_lag, eps=c.gcc_eps,
                plan=self.plan,
            )
            mark("channel_step")
            peaks = detect_ops.peaks_from_ct_partials(*partials, nfft=nfft_m, **tail)
            mark("peaks")
            corr = gcc_ops.peaks_from_lag_mags(
                window, sample_rate_hz=c.sample_rate_hz, max_lag=c.max_lag
            )
            mark("lag_peaks")
            return self._solve_marked(peaks, corr, anchors_enu, mark)
        row_smax = None
        if combined:
            in_kernel_topk = detect_ops.combined_topk_enabled()  # K1 finishes the selection
            spectra, partials, row_smax = sc_ops.receiver_spectra_ct_detect(
                re, im, max_lag=c.max_lag, plan=self.plan, emit_topk=c.max_peaks if in_kernel_topk else 0
            )
            mark("fft_detect")
            peaks = detect_ops.detect_peaks_ct(
                spectra[0], spectra[1], threshold_db=c.detection_threshold_db,
                partials=partials, kernel_topk=in_kernel_topk, **tail,
            )
            mark("peaks")
        else:
            spectra = sc_ops.receiver_spectra_ct(re, im, max_lag=c.max_lag)
            mark("spectra")
            if fused_detect:
                peaks = detect_ops.detect_peaks_ct(
                    spectra[0], spectra[1], threshold_db=c.detection_threshold_db, **tail
                )
            else:
                power_db = sc_ops.ct_power_db(spectra[0], spectra[1])
                peaks = self._detect_natural(power_db + c.power_offset_db)
            mark("detect")
        corr = sc_ops.gcc_phat_all_pairs_split_fused(
            re, im, sample_rate_hz=c.sample_rate_hz, max_lag=c.max_lag,
            weighting=c.weighting, eps=c.gcc_eps, spectra=spectra, row_smax=row_smax,
        )
        mark("gcc_pair")
        return self._solve_marked(peaks, corr, anchors_enu, mark)

    def _detect_natural(self, power_db: torch.Tensor) -> detect_ops.PeakSet:
        """Natural-order detection of a dB spectrum (any grid)."""
        c = self.config
        return detect_ops.detect_peaks(
            power_db,
            sample_rate_hz=c.sample_rate_hz,
            max_peaks=c.max_peaks,
            threshold_db=c.detection_threshold_db,
            noise_floor_stride=c.noise_floor_stride,
        )

    def _solve_marked(self, peaks, corr, anchors_enu, mark) -> PipelineOutput:
        out = self._finish(peaks, corr, anchors_enu)
        mark("solve")
        return out

    def _step_split_unfused(self, re, im, anchors_enu, mark) -> PipelineOutput:
        """Single dwell without the fused chain: natural-order spectra of
        the padded blocks feed the split GCC, and the detector reads the
        N-point spectrum (the padded spectra's even bins when nfft is
        exactly 2N, else its own transform)."""
        c = self.config
        n = c.block_len
        spectra = sc_ops.receiver_spectra_split(re, im, max_lag=c.max_lag)
        mark("spectra")
        fr, fi, nfft = spectra
        if nfft == 2 * n:
            power_db = 10.0 * torch.log10(fr[..., ::2] ** 2 + fi[..., ::2] ** 2 + 1e-24)
        else:
            power_db = sc_ops.power_spectrum_db_split(re, im)
        peaks = self._detect_natural(power_db + c.power_offset_db)
        mark("detect")
        corr = sc_ops.gcc_phat_all_pairs_split(
            re, im, sample_rate_hz=c.sample_rate_hz, max_lag=c.max_lag,
            weighting=c.weighting, eps=c.gcc_eps, spectra=spectra,
        )
        mark("pair_corr")
        return self._solve_marked(peaks, corr, anchors_enu, mark)

    def _step_split_multidwell(self, re, im, anchors_enu, mark) -> PipelineOutput:
        """Narrowband route: dwell-averaged PSD detection on the block_len
        grid + one coherent correlation of the whole K·N capture."""
        c = self.config
        k, n = c.correlation_dwells, c.block_len
        re = re.to(torch.float32)
        im = im.to(torch.float32)
        dwell_db = sc_ops.power_spectrum_db_split(
            re.reshape(*re.shape[:-1], k, n), im.reshape(*im.shape[:-1], k, n)
        )  # [..., B, K, N]
        power_db = (
            10.0 * torch.log10((10.0 ** (dwell_db / 10.0)).mean(dim=-2) + 1e-30)
            + c.power_offset_db
        )
        del dwell_db
        mark("psd")
        peaks = detect_ops.detect_peaks(
            power_db,
            sample_rate_hz=c.sample_rate_hz,
            max_peaks=c.max_peaks,
            threshold_db=c.detection_threshold_db,
            noise_floor_stride=c.noise_floor_stride,
        )
        mark("detect")

        corr = self._pair_stage(re, im, mark)
        return self._solve_marked(peaks, corr, anchors_enu, mark)

    @spans.entry
    def step_split_uint8(
        self, raw: torch.Tensor, anchors_enu: torch.Tensor, *, on_stage: StageHook = None
    ) -> PipelineOutput:
        """Pipeline from raw interleaved uint8 bytes ``[..., B, 2·K·N]``."""
        self._on_device(raw)
        re, im = iq_ops.decode_uint8_split(raw)
        if on_stage is not None:
            on_stage("decode")
        return self.step_split(re, im, anchors_enu, on_stage=on_stage)

    # -- multi-block steps ----------------------------------------------

    def step_split_uint8_scan(
        self, raw: torch.Tensor, anchors_enu: torch.Tensor
    ) -> PipelineOutput:
        """T consecutive blocks ``raw [T, ..., B, 2·K·N]``, one at a time,
        with shared anchors; outputs stack on a leading T axis (block t at
        t)."""
        return _stack([self.step_split_uint8(blk, anchors_enu) for blk in raw.unbind(0)])

    def step_split_scan(
        self, re: torch.Tensor, im: torch.Tensor, anchors_enu: torch.Tensor
    ) -> PipelineOutput:
        """Scan variant of :meth:`step_split`: ``re/im [T, ..., B, K·N]``."""
        return _stack([
            self.step_split(r, i, anchors_enu) for r, i in zip(re.unbind(0), im.unbind(0))
        ])

    # -- example inputs ---------------------------------------------------

    def example_inputs(self, *, batch: tuple = (), seed: int = 0, uint8: bool = False):
        """Random inputs on the pipeline's device, drawn from numpy
        ``default_rng(seed)`` in the JAX package's order (anchors first), so
        both packages see the same values; the capture is ``K·N`` samples
        per buoy (K = ``correlation_dwells``). Returns ``(raw, anchors)``
        with ``uint8=True``, else ``(re, im, anchors)``."""
        c = self.config
        length = c.correlation_dwells * c.block_len
        rng = np.random.default_rng(seed)
        anchors = rng.normal(scale=8_000.0, size=(c.num_buoys, 3)).astype(np.float32)
        anchors[:, 2] = 0.0
        anchors = np.array(np.broadcast_to(anchors, (*batch, c.num_buoys, 3)))
        to = lambda a: torch.from_numpy(a).to(self.device)
        if uint8:
            raw = rng.integers(0, 256, size=(*batch, c.num_buoys, 2 * length), dtype=np.uint8)
            return to(raw), to(anchors)
        re = rng.normal(size=(*batch, c.num_buoys, length)).astype(np.float32)
        im = rng.normal(size=(*batch, c.num_buoys, length)).astype(np.float32)
        return to(re), to(im), to(anchors)


def _stack(outs):
    """Stack a list of (nested) NamedTuples of tensors on a new axis 0."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return type(first)(*(_stack([o[i] for o in outs]) for i in range(len(first))))
