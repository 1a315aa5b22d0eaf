"""Pair-parallel (EP) GCC-PHAT + solve over a mesh axis of ranks.

Port of ``radio_mapper_tpu/parallel/pair_ep.py``. The O(B²) pair stage is
split over the ranks of one axis ("pair"):

  1. receivers shard over the axis — each rank transforms its B/n
     receivers only;
  2. one all_gather shares the B spectra (B ≪ P — the cheap direction);
  3. each rank whitens and inverts only its P/n pair slice;
  4. the LM solve runs with ``psum`` (:func:`..solver.solve_tdoa_impl`):
     the ranks' normal equations are summed every iteration, so every
     rank computes the identical global fix and no pair measurement is
     ever gathered.

Routes of the pair slice, as the reference's:

- fused (CUDA ranks, or CPU ranks with ``split_complex.set_gcc_fused("on")``):
  kernel K3 (``fft_rows_ct``) on this rank's receivers, the all_gather of
  the CT-order spectra, the l2rx gate scales from per-receiver maxima,
  then kernel K5 (``gcc_pairs_onehot_lag_mags``) with this rank's pair
  slice as data where ``gcc_pair.onehot_pairs_enabled`` says so, else the
  slice's rows gathered by index and kernel K6 (``gcc_rows_lag_mags``);
- unfused (CPU ranks; the reference's route off the TPU): natural-order
  spectra, the gathered pairs, PHAT whitening with the per-pair max gate,
  the inverse by conjugation and the lag window.

Both then pick the peaks, zero the padded pairs' weights and solve.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from radio_mapper_tpu_torch import solver
from radio_mapper_tpu_torch.ops import fft as fft_ops
from radio_mapper_tpu_torch.ops import gcc_phat as gcc_ops
from radio_mapper_tpu_torch.ops import safe
from radio_mapper_tpu_torch.ops import split_complex as sc_ops
from radio_mapper_tpu_torch.ops.cuda import gcc_pair
from radio_mapper_tpu_torch.parallel import collectives
from radio_mapper_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class PairEPConfig:
    num_buoys: int = 64
    block_len: int = 4096
    sample_rate_hz: float = 2_048_000.0
    max_lag: int = 256
    weighting: str = "phat"
    gcc_eps: float = 0.05
    solver_iterations: int = 25
    psr_floor: float = 1.1
    psr_scale: float = 2.0

    @property
    def num_pairs(self) -> int:
        return self.num_buoys * (self.num_buoys - 1) // 2


class PairEPOutput(NamedTuple):
    fix_enu: torch.Tensor  # [3] — identical on every rank (psum-solved)
    cost: torch.Tensor  # []
    lags: torch.Tensor  # [P_pad / n] this rank's pair lags
    weights: torch.Tensor  # [P_pad / n]
    # 1σ horizontal error ellipse of the fix (solver CRLB; replicated)
    ellipse_major_m: torch.Tensor  # []
    ellipse_minor_m: torch.Tensor  # []
    ellipse_orientation_deg: torch.Tensor  # []


OUT_SPEC = PairEPOutput(
    fix_enu=(), cost=(), lags=("pair",), weights=("pair",),
    ellipse_major_m=(), ellipse_minor_m=(), ellipse_orientation_deg=(),
)


def _padded_pairs(num_buoys: int, num_shards: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(i, j) pair arrays padded to a multiple of the shard count.

    Padding repeats pair (0, 1) with its weight forced to 0 downstream,
    keeping every rank's slice the same size.
    """
    i_idx, j_idx = gcc_ops.pair_indices(num_buoys)
    p = len(i_idx)
    p_pad = -(-p // num_shards) * num_shards
    pad = p_pad - p
    return (
        np.concatenate([i_idx, np.zeros(pad, np.int32)]),
        np.concatenate([j_idx, np.ones(pad, np.int32)]),
        p,
    )


class PairEPStep:
    """The EP step of one rank (:func:`build_pair_ep_step`), callable as
    ``step(re_l, im_l, anchors_enu) -> PairEPOutput``; its stages are
    methods, so a caller can hold a kernel against its plain version on
    exactly this rank's pair slice."""

    def __init__(self, mesh: DeviceMesh, config: PairEPConfig, axis: str):
        cfg = self.config = config
        ax = self.axis = mesh_lib.axis(mesh, axis)
        if cfg.num_buoys % ax.size:
            raise ValueError(f"num_buoys {cfg.num_buoys} must divide over {ax.size} shards")
        pair_i, pair_j, self.num_real_pairs = _padded_pairs(cfg.num_buoys, ax.size)
        p_loc = len(pair_i) // ax.size
        mine = slice(ax.index * p_loc, (ax.index + 1) * p_loc)
        self.pair_i, self.pair_j = pair_i[mine], pair_j[mine]  # this rank's pair slice (host)
        self.nfft = fft_ops.friendly_fft_len(cfg.block_len + cfg.max_lag)
        use_fused = sc_ops.gcc_fused_enabled(cfg.block_len + cfg.max_lag, cfg.weighting)
        # CPU ranks fuse only when forced on (the reference: only TPU meshes)
        if sc_ops.gcc_fused_mode() != "on" and mesh.device_type != "cuda":
            use_fused = False
        self.use_fused = use_fused
        dev = mesh_lib.rank_device(mesh)
        self._pi = torch.from_numpy(self.pair_i.astype(np.int64)).to(dev)
        self._pj = torch.from_numpy(self.pair_j.astype(np.int64)).to(dev)
        valid = (np.arange(len(pair_i)) < self.num_real_pairs)[mine]
        self._valid = torch.from_numpy(valid.astype(np.float32)).to(dev)
        self._psum = collectives.psum(ax)

    def spectra(self, re_l: torch.Tensor, im_l: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every receiver's spectrum ``[B, nfft]`` from this rank's ``[B/n,
        N]``: K3 (CT order) on the fused route, the natural-order FFT
        otherwise, then one all_gather of ``[2, B/n, nfft]``."""
        cfg = self.config
        re_l, im_l = re_l.to(torch.float32), im_l.to(torch.float32)
        if self.use_fused:
            fr_l, fi_l, _ = sc_ops.receiver_spectra_ct(re_l, im_l, max_lag=cfg.max_lag)  # K3
        else:
            pad = lambda a: F.pad(a, (0, self.nfft - cfg.block_len))
            fr_l, fi_l = fft_ops.fft_re_im(pad(re_l), pad(im_l))
        fr, fi = collectives.all_gather(torch.stack([fr_l, fi_l]), self.axis, dim=1).unbind(0)
        return fr, fi

    def gathered_pairs(self, fr: torch.Tensor, fi: torch.Tensor):
        """``(X re, X im, Y re, Y im)`` ``[P_loc, nfft]``: the pair slice's rows."""
        sel = lambda x, idx: safe.pair_select(x, idx, axis=-2)
        return sel(fr, self._pi), sel(fi, self._pi), sel(fr, self._pj), sel(fi, self._pj)

    def gate_scales(self, fr: torch.Tensor, fi: torch.Tensor) -> Optional[torch.Tensor]:
        """The fused route's l2rx gate scales ``[P_loc]`` from per-receiver
        maxima (one [B, nfft] reduction instead of a [P_loc, nfft] one in
        the pair kernel), or None where the gate takes none."""
        if self.config.weighting != "phat" or gcc_pair.phat_gate() != "l2rx":
            return None
        rmax = (fr * fr + fi * fi).amax(dim=-1)  # [B]
        return safe.pair_select(rmax, self._pi) * safe.pair_select(rmax, self._pj)

    def onehot(self) -> bool:
        """Does the fused route take K5 (else K6)?"""
        cfg = self.config
        return gcc_pair.onehot_pairs_enabled(cfg.num_buoys, sc_ops.planned_ct_nfft(cfg.block_len + cfg.max_lag))

    def lag_mags(self, fr: torch.Tensor, fi: torch.Tensor) -> torch.Tensor:
        """The pair slice's lag windows ``[P_loc, 2L+1]`` from the gathered
        spectra."""
        cfg = self.config
        L = cfg.max_lag
        if self.use_fused:
            kw = dict(max_lag=L, eps=cfg.gcc_eps, weighting=cfg.weighting, s2=self.gate_scales(fr, fi))
            if self.onehot():  # K5, the pair slice as data
                return gcc_pair.gcc_pairs_onehot_lag_mags(fr, fi, self.pair_i, self.pair_j, **kw)
            return gcc_pair.gcc_rows_lag_mags(*self.gathered_pairs(fr, fi), **kw)  # K6
        # R = X·conj(Y), PHAT whitening (per-pair max gate)
        nfft = self.nfft
        xfr, xfi, yfr, yfi = self.gathered_pairs(fr, fi)
        rre = xfr * yfr + xfi * yfi
        rim = xfi * yfr - xfr * yfi
        if cfg.weighting == "phat":
            mag = torch.sqrt(rre * rre + rim * rim)
            scale = mag.amax(dim=-1, keepdim=True)
            denom = mag + cfg.gcc_eps * scale + 1e-30
            rre, rim = rre / denom, rim / denom
        cre, cim = fft_ops.fft_re_im(rre, -rim)
        cre, cim = cre / nfft, -cim / nfft  # ifft via conj trick
        win = lambda a: torch.cat([a[..., nfft - L:], a[..., : L + 1]], dim=-1)
        return torch.sqrt(win(cre) ** 2 + win(cim) ** 2)

    def __call__(self, re_l: torch.Tensor, im_l: torch.Tensor, anchors: torch.Tensor) -> PairEPOutput:
        cfg = self.config
        m = self.lag_mags(*self.spectra(re_l, im_l))
        pk = gcc_ops.peaks_from_lag_mags(m, sample_rate_hz=cfg.sample_rate_hz, max_lag=cfg.max_lag)
        weights = (torch.clamp((pk.psr - cfg.psr_floor) / cfg.psr_scale, 0.0, 1.0) + 1e-3) * self._valid
        dd = solver.tau_to_distance_difference(pk.tau_s)
        res = solver.solve_tdoa_impl(
            anchors.to(torch.float32), self._pi, self._pj, dd, weights,
            iterations=cfg.solver_iterations, psum=self._psum,
        )
        return PairEPOutput(
            fix_enu=res.position_enu,
            cost=res.cost,
            lags=pk.lag_samples,
            weights=weights,
            ellipse_major_m=res.ellipse_major_m,
            ellipse_minor_m=res.ellipse_minor_m,
            ellipse_orientation_deg=res.ellipse_orientation_deg,
        )


def build_pair_ep_step(mesh: DeviceMesh, config: PairEPConfig, *, axis: str = "pair"):
    """The EP step for this rank of ``mesh``.

    Returns ``(step_fn, in_specs, (pair_i, pair_j))`` with
    ``step_fn(re_l, im_l, anchors_enu) -> PairEPOutput`` (a
    :class:`PairEPStep`):

      re_l/im_l:   this rank's ``[B/n, N]`` float32 receivers (spec
                   ``(axis, None)``);
      anchors_enu: ``[B, 3]`` float32, replicated;

    and the unpadded pair lists of the global pair order.
    """
    step = PairEPStep(mesh, config, axis)
    i_idx, j_idx = gcc_ops.pair_indices(config.num_buoys)
    return step, ((axis, None), (axis, None), mesh_lib.replicated()), (i_idx, j_idx)
