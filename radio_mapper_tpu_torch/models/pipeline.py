"""The flagship end-to-end TDOA pipeline: decode → detect → correlate → solve.

Port of ``radio_mapper_tpu/models/pipeline.py`` on the route the TPU
runs by default (the fused FFT + detect kernel feeding the fused pair
stage):

    uint8 IQ [..., B, 2N] → (re, im) f32                 ops.iq
      → zero-pad to nfft = ct_plan.plan_nfft(N + max_lag)
      → K1: CT-order FFT + detect partials + row max     ops.cuda.fft_detect
      → top-K tail                                       ops.detect
      → K2: all-pairs whiten × inverse DFT × lag window  ops.cuda.gcc_pair
      → argmax + parabolic τ + PSR                       ops.gcc_phat
      → pair weights → LM solve + GLS ellipse            solver

All leading dims are batch dims (``[channels, B, N]``). PyTorch runs
eagerly, so the "step" is a plain call; the K-block scan is a loop over
the leading axis, so the working set stays one block.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from radio_mapper_tpu_torch import constants, solver
from radio_mapper_tpu_torch.ops import ct_plan
from radio_mapper_tpu_torch.ops import detect as detect_ops
from radio_mapper_tpu_torch.ops import gcc_phat as gcc_ops
from radio_mapper_tpu_torch.ops import iq as iq_ops
from radio_mapper_tpu_torch.ops.cuda import fft_detect, gcc_pair


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
        # Routes of the JAX package not ported yet (ROADMAP M6).
        if self.correlation_dwells > 1:
            raise NotImplementedError("correlation_dwells > 1 is not ported")
        if self.solver_starts > 1:
            raise NotImplementedError("solver_starts > 1 is not ported")
        if self.weighting != "phat":
            raise NotImplementedError(f"weighting {self.weighting!r} is not ported (phat only)")
        if self.noise_floor_stride != ct_plan.SEGMENT:
            raise NotImplementedError(
                f"the fused detector takes noise_floor_stride={ct_plan.SEGMENT} only"
            )
        return self

    @property
    def num_pairs(self) -> int:
        return self.num_buoys * (self.num_buoys - 1) // 2

    @property
    def nfft(self) -> int:
        return ct_plan.plan_nfft(self.block_len + self.max_lag)


class PipelineOutput(NamedTuple):
    peaks: detect_ops.PeakSet  # per-buoy detections [..., B, K]; bin_index on the nfft grid
    correlation: gcc_ops.CorrelationPeak  # per-pair TDOA [..., P]
    pair_weights: torch.Tensor  # [..., P]
    fix: solver.SolveResult  # [...]-batched position solution
    buoy_confidence: torch.Tensor  # [..., B] strongest-peak confidence


StageHook = Optional[Callable[[str], None]]


class TDOAPipeline:
    """The flagship step for a fixed configuration on one device.

    ``device`` is explicit: inputs must already lie on it. On a CUDA
    device the two stages K1 and K2 run the hand-written kernels; on the
    CPU they run their plain PyTorch versions.
    """

    def __init__(self, config: PipelineConfig, *, device: torch.device | str):
        self.config = config.validate()
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        i_idx, j_idx = gcc_ops.pair_indices(config.num_buoys)
        self.pair_i_np, self.pair_j_np = i_idx, j_idx
        self.pair_i = torch.as_tensor(i_idx, dtype=torch.int64, device=self.device)
        self.pair_j = torch.as_tensor(j_idx, dtype=torch.int64, device=self.device)
        c = self.config
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
        c = self.config
        weights = self.pair_weights(peaks, corr)
        fix = solver.solve_tdoa_impl(
            anchors_enu,
            self.pair_i,
            self.pair_j,
            solver.tau_to_distance_difference(corr.tau_s),
            weights,
            solve_2d=c.solve_2d,
            iterations=c.solver_iterations,
        )
        buoy_conf = torch.where(peaks.valid, peaks.confidence, 0.0).amax(dim=-1)
        return PipelineOutput(
            peaks=peaks,
            correlation=corr,
            pair_weights=weights,
            fix=fix,
            buoy_confidence=buoy_conf,
        )

    # -- full steps -----------------------------------------------------

    def step_split(
        self, re: torch.Tensor, im: torch.Tensor, anchors_enu: torch.Tensor,
        *, on_stage: StageHook = None,
    ) -> PipelineOutput:
        """Full pipeline on float32 ``(re, im)`` ``[..., B, N]`` and anchors
        ``[..., B, 3]``.

        ``on_stage(name)``, when given, is called after each stage
        ("pad", "fft_detect", "peaks", "gcc_pair", "lag_peaks", "solve") —
        a hook for per-stage timing; it changes nothing else.
        """
        c = self.config
        mark = on_stage or (lambda _name: None)
        self._on_device(re, im, anchors_enu)
        if re.shape != im.shape or re.shape[-2:] != (c.num_buoys, c.block_len):
            raise ValueError(
                f"need re/im [..., {c.num_buoys}, {c.block_len}], got {tuple(re.shape)}"
            )
        batch = re.shape[:-2]
        nfft = self.plan.nfft
        pad = lambda a: F.pad(a.to(torch.float32), (0, nfft - c.block_len)).reshape(-1, nfft)
        re_p, im_p = pad(re), pad(im)
        mark("pad")

        fr, fi, score, arg, nf, rmax = fft_detect.fft_detect_rows_ct(re_p, im_p, self.plan)
        mark("fft_detect")

        bshape = (*batch, c.num_buoys)
        s = self.plan.segments
        peaks = detect_ops.peaks_from_ct_partials(
            score.reshape(*bshape, s), arg.reshape(*bshape, s), nf.reshape(bshape),
            nfft=nfft,
            sample_rate_hz=c.sample_rate_hz,
            max_peaks=c.max_peaks,
            snr_fullscale_db=constants.DEFAULT_SNR_FULLSCALE_DB,
            power_offset_db=c.power_offset_db,
        )
        mark("peaks")

        cb = (-1, c.num_buoys)
        mags = gcc_pair.gcc_pair_lag_mags(
            fr.reshape(*cb, nfft), fi.reshape(*cb, nfft), rmax.reshape(cb),
            self.pair_i_np, self.pair_j_np,
            max_lag=c.max_lag, eps=c.gcc_eps,
        )
        mark("gcc_pair")

        corr = gcc_ops.peaks_from_lag_mags(
            mags.reshape(*batch, c.num_pairs, 2 * c.max_lag + 1),
            sample_rate_hz=c.sample_rate_hz, max_lag=c.max_lag,
        )
        mark("lag_peaks")

        out = self._finish(peaks, corr, anchors_enu)
        mark("solve")
        return out

    def step_split_uint8(
        self, raw: torch.Tensor, anchors_enu: torch.Tensor, *, on_stage: StageHook = None
    ) -> PipelineOutput:
        """Pipeline from raw interleaved uint8 bytes ``[..., B, 2N]``."""
        self._on_device(raw)
        re, im = iq_ops.decode_uint8_split(raw)
        if on_stage is not None:
            on_stage("decode")
        return self.step_split(re, im, anchors_enu, on_stage=on_stage)

    # -- multi-block steps ----------------------------------------------

    def step_split_uint8_scan(
        self, raw: torch.Tensor, anchors_enu: torch.Tensor
    ) -> PipelineOutput:
        """K consecutive blocks ``raw [K, ..., B, 2N]``, one at a time, with
        shared anchors; outputs stack on a leading K axis (block k at k)."""
        return _stack([self.step_split_uint8(blk, anchors_enu) for blk in raw.unbind(0)])

    def step_split_scan(
        self, re: torch.Tensor, im: torch.Tensor, anchors_enu: torch.Tensor
    ) -> PipelineOutput:
        """Scan variant of :meth:`step_split`: ``re/im [K, ..., B, N]``."""
        return _stack([
            self.step_split(r, i, anchors_enu) for r, i in zip(re.unbind(0), im.unbind(0))
        ])

    # -- example inputs ---------------------------------------------------

    def example_inputs(self, *, batch: tuple = (), seed: int = 0, uint8: bool = False):
        """Random inputs on the pipeline's device, drawn from numpy
        ``default_rng(seed)`` in the JAX package's order (anchors first), so
        both packages see the same values. Returns ``(raw, anchors)`` with
        ``uint8=True``, else ``(re, im, anchors)``."""
        c = self.config
        rng = np.random.default_rng(seed)
        anchors = rng.normal(scale=8_000.0, size=(c.num_buoys, 3)).astype(np.float32)
        anchors[:, 2] = 0.0
        anchors = np.array(np.broadcast_to(anchors, (*batch, c.num_buoys, 3)))
        to = lambda a: torch.from_numpy(a).to(self.device)
        if uint8:
            raw = rng.integers(0, 256, size=(*batch, c.num_buoys, 2 * c.block_len), dtype=np.uint8)
            return to(raw), to(anchors)
        re = rng.normal(size=(*batch, c.num_buoys, c.block_len)).astype(np.float32)
        im = rng.normal(size=(*batch, c.num_buoys, c.block_len)).astype(np.float32)
        return to(re), to(im), to(anchors)


def _stack(outs):
    """Stack a list of (nested) NamedTuples of tensors on a new axis 0."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    return type(first)(*(_stack([o[i] for o in outs]) for i in range(len(first))))
