"""The correctness check: what the timed path returned, against the plain
reference recomputed from the same raw bytes.

Every answer of each sampled dispatch is compared, in chunks of
channel-blocks so that the reference fits beside the inputs:

- ``peak_power_db``: the program's peak powers against the reference's
  spectrum at the same bins (dB);
- ``peak_pick_db``: whether those bins are the reference's picks, as the
  least change of the reference's spectrum (dB) that would make them so:
  how far each pick lies below its ±10-bin neighbourhood, below the gate
  or inside the DC notch (100 dB); how far the picks stray from
  strongest-first order; and for each reference candidate that no pick
  stands within ±10 bins of and that is stronger than the weakest pick
  (or than the gate, where the program listed fewer than K), the lesser
  of that excess and what would unmake it a candidate (its lead over the
  strongest other bin of its neighbourhood, or over the gate). A near-tie
  that flips which of two bins is the local maximum, or whether a bin
  clears the gate, reads as small as the tie was;
- ``floor_db``: the noise floor;
- ``lag_pick``: how far the reference's |r| at the program's integer lag
  lies below the reference's largest, over that largest;
- ``tau_drop``: how far the reference's correlation, on the parabola
  through its three lags at the program's integer lag, lies below its
  vertex at the program's sub-sample lag, over the reference's largest
  |r|: a sub-sample lag is judged by the correlation it claims, so on a
  flat top, where the vertex is ill conditioned, any lag near it reads
  small, and on a sharp peak a small offset reads large;
- ``psr_inv``: the program's PSR against the reference's, as the gap of
  their inverses (the largest sidelobe over the peak), which is well
  conditioned where the sidelobes are small;
- ``fix_cost``: how much higher the reference's weighted cost (its own
  lags and weights, float64) is at the program's fix than at the
  reference's own LM solve, over the latter: a fix is judged by the
  objective both solves minimise, so two starts that end at equally good
  minima, or an unconverged solve that drifts along a flat valley, read
  as small as their costs differ.

The reference picks its own lags (the largest |r|), weights them and
solves. Only where the program's integer lag (the integer below or
above its sub-sample lag) differs from the reference's and its |r| lies
within ``lag_pick``'s limit of the largest (a near-tie on a flat top) is
the reference also evaluated there: ``psr_inv`` takes the lesser of the
PSR gaps, and ``fix_cost`` the lesser of the cost gaps of the two
solves, the second with the program's nearest integer lag in each
near-tied pair.

Each number is the largest over every answer compared; a NaN fails.
"""

from __future__ import annotations

import math

import torch

from reference import tdoa

NUMBERS = ("peak_power_db", "peak_pick_db", "floor_db", "lag_pick", "tau_drop", "psr_inv", "fix_cost")
NOTCH_GAP_DB = 100.0


def _max(acc: dict, name: str, value: torch.Tensor) -> None:
    """Fold the largest of ``value`` into ``acc[name]``; a NaN sticks."""
    if value.numel() == 0:
        v = 0.0
    elif bool(torch.isnan(value).any()):
        v = float("nan")
    else:
        v = float(value.max())
    old = acc.get(name)
    if old is None or math.isnan(v):
        acc[name] = v
    elif not math.isnan(old):
        acc[name] = max(old, v)


def _circular_near(a: torch.Tensor, b: torch.Tensor, n: int, radius: int) -> torch.Tensor:
    """``[R, Ka, Kb]``: bins ``a [R, Ka]`` and ``b [R, Kb]`` within
    ``radius`` of each other on a circle of ``n`` bins."""
    d = (a.unsqueeze(-1) - b.unsqueeze(-2)).remainder(n)
    return torch.minimum(d, n - d) <= radius


def _peaks(acc, det: tdoa.Detection, bins, valid, power, floor):
    """Compare the program's peaks ``[R, K]`` with the reference's detection."""
    f = det.power_db.shape[-1]
    radius = tdoa.MIN_DISTANCE_BINS
    bins = bins.to(torch.int64).clamp(0, f - 1)
    at = det.power_db.gather(-1, bins)
    zero = torch.zeros_like(at)
    ninf = torch.full_like(at, float("-inf"))
    _max(acc, "peak_power_db", torch.where(valid, (power - at).abs(), zero))
    gate = det.gate_db.unsqueeze(-1)
    # each pick: how far from being a candidate of the reference
    below_max = (det.local_max_db.gather(-1, bins) - at).clamp(min=0.0)
    below_gate = (gate - at).clamp(min=0.0)
    in_notch = det.notch[bins].to(at.dtype) * NOTCH_GAP_DB
    margin = torch.where(valid, torch.maximum(torch.maximum(below_max, below_gate), in_notch), zero)
    # the picks' order, strongest first
    listed = torch.where(valid, at, ninf)
    ranked = torch.sort(listed, dim=-1, descending=True).values
    order = torch.where(torch.isfinite(ranked) & valid, (ranked - listed).abs(), zero)
    # the reference's candidates that no pick stands in for
    cand, cbins = det.cand_db, det.cand_bins
    stood_in = (_circular_near(bins, cbins, f, radius) & valid.unsqueeze(-1)).any(dim=-2)
    weakest = torch.where(valid.all(dim=-1), listed.amin(dim=-1), det.gate_db).unsqueeze(-1)
    offs = torch.cat([torch.arange(-radius, 0), torch.arange(1, radius + 1)]).to(cbins.device)
    around = (cbins.unsqueeze(-1) + offs).remainder(f).reshape(cbins.shape[0], -1)
    rival = det.power_db.gather(-1, around).reshape(*cbins.shape, offs.numel()).amax(dim=-1)
    unmake = torch.minimum(cand - rival, cand - gate).clamp(min=0.0)
    missed = torch.isfinite(cand) & ~stood_in & (cand > weakest)
    miss = torch.where(missed, torch.minimum(cand - weakest, unmake), torch.zeros_like(cand))
    _max(acc, "peak_pick_db", torch.cat([torch.maximum(margin, order), miss], dim=-1))
    _max(acc, "floor_db", (floor - det.floor_db).abs())


def _lag_gaps(m_ref, lag_prog, max_lag):
    """``(candidates, gaps)``: the program's integer lag indices, the
    integer below and above its sub-sample lag (a parabola's vertex lies
    within half a lag of its peak, so a lag ending in .5 names either),
    each with the reference's |r| there; and ``lag_pick`` and
    ``tau_drop``, each the lesser over the two."""
    width = m_ref.shape[-1]
    m_max = m_ref.amax(dim=-1).to(torch.float64) + 1e-30
    lag = lag_prog.to(torch.float64)
    take = lambda j: m_ref.gather(-1, j.clamp(0, width - 1).unsqueeze(-1)).squeeze(-1).to(torch.float64)
    cands, gaps = [], None
    for k in (torch.floor(lag + max_lag), torch.ceil(lag + max_lag)):
        k = k.to(torch.int64).clamp(0, width - 1)
        ym1, y0, yp1 = take(k - 1), take(k), take(k + 1)
        vertex = tdoa.parabola(m_ref, k).to(torch.float64)
        t = lag - (k.to(torch.float64) - max_lag)
        curve = lambda x: 0.5 * (yp1 - ym1) * x + 0.5 * (ym1 - 2.0 * y0 + yp1) * x * x
        inner = (k >= 1) & (k <= width - 2)
        drop = torch.where(inner, (curve(vertex) - curve(t)).clamp(min=0.0) / m_max, t.abs())
        g = {"lag_pick": (m_max - y0) / m_max, "tau_drop": drop}
        gaps = g if gaps is None else {name: torch.minimum(v, gaps[name]) for name, v in g.items()}
        cands.append((k, g["lag_pick"]))
    return cands, gaps


def _cost_gap(anchors64, tau, weights, fix_ref, fix_prog):
    c_ref = tdoa.weighted_cost(anchors64, tau, weights, fix_ref)
    c_prog = tdoa.weighted_cost(anchors64, tau, weights, fix_prog)
    return (c_prog - c_ref).clamp(min=0.0) / (c_ref + 1e-12)


def compare(raw: torch.Tensor, anchors: torch.Tensor, out, step: tdoa.Step, tie_limit: float) -> dict:
    """The numbers for one dispatch: ``raw [*lead, B, 2·K·N]`` uint8, the
    program's output ``out`` (peaks, correlation, fix with ``[*lead, …]``
    fields); ``tie_limit``, ``lag_pick``'s limit, bounds a near-tie."""
    p = tdoa.Precision()
    b = step.num_buoys
    flat = lambda t, tail: t.reshape(-1, *tail)
    raw = flat(raw, raw.shape[-2:])
    kk = step.max_peaks
    pk = out.peaks
    bins, valid = flat(pk.bin_index, (b, kk)), flat(pk.valid, (b, kk))
    power, floor = flat(pk.power_db, (b, kk)), flat(pk.noise_floor_db, (b,))
    npairs = b * (b - 1) // 2
    lag_prog = flat(out.correlation.lag_samples, (npairs,))
    psr_prog = flat(out.correlation.psr, (npairs,))
    fix_prog = flat(out.fix.position_enu, (3,))
    chunk = tdoa.chunk_blocks(step)
    fs = step.sample_rate_hz
    acc: dict = {}
    dev = raw.device
    anchors64 = anchors.to(dev, torch.float64)
    for s in range(0, raw.shape[0], chunk):
        e = min(s + chunk, raw.shape[0])
        c = e - s
        ref = tdoa.reference_chunk(raw[s:e], anchors64, step, p)
        det = ref.detection
        _peaks(acc, det, bins[s:e].to(dev).reshape(c * b, kk), valid[s:e].to(dev).reshape(c * b, kk),
               power[s:e].to(dev).reshape(c * b, kk), floor[s:e].to(dev).reshape(c * b))
        cands, gaps = _lag_gaps(ref.window, lag_prog[s:e].to(dev), step.max_lag)
        for name, v in gaps.items():
            _max(acc, name, v)
        inv = lambda q: 1.0 / q.clamp(min=1e-12)
        psr_c = psr_prog[s:e].to(dev)
        psr_gap = (inv(psr_c) - inv(ref.psr)).abs()
        x = fix_prog[s:e].to(dev, torch.float64)
        fix_gap = _cost_gap(anchors64, ref.lag / fs, ref.weights, ref.fix, x)
        # near-ties: the program's integer lag where it is not the reference's
        ties = [(k, (k != ref.pick) & (gap <= tie_limit)) for k, gap in cands]
        for k, tie in ties:
            if bool(tie.any()):
                psr_k = tdoa.psr(ref.window, k)
                psr_gap = torch.where(tie, torch.minimum(psr_gap, (inv(psr_c) - inv(psr_k)).abs()), psr_gap)
        # the solve again at the program's nearest integer lag, where that is a near-tie
        k_near = torch.round(lag_prog[s:e].to(dev, torch.float64) + step.max_lag).to(torch.int64)
        tie = torch.zeros_like(ref.pick, dtype=torch.bool)
        for k, t in ties:
            tie |= t & (k == k_near)
        if bool(tie.any()):
            lag_t, psr_t = tdoa.lag_at(ref.window, k_near.clamp(0, ref.window.shape[-1] - 1), step)
            rows = tie.any(dim=-1)
            lag_t = torch.where(tie, lag_t, ref.lag)[rows]
            psr_t = torch.where(tie, psr_t, ref.psr)[rows]
            w_t = tdoa.pair_weights(det.confidence.reshape(c, b)[rows], psr_t, step)
            fix_t = tdoa.solve(anchors64, lag_t / fs, w_t, step)
            fix_gap[rows] = torch.minimum(fix_gap[rows], _cost_gap(anchors64, lag_t / fs, w_t, fix_t, x[rows]))
        _max(acc, "psr_inv", psr_gap)
        _max(acc, "fix_cost", fix_gap)
        del ref, det
    return acc


def merge(results: list) -> dict:
    """The largest of each number over several dispatches' results."""
    out: dict = {}
    for r in results:
        for k, v in r.items():
            _max(out, k, torch.tensor([v]))
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [(name, value, limit)])``: every number at or under its
    limit (a NaN or a missing number fails)."""
    rows = []
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        rows.append((name, v, limit))
        if not (v <= limit):
            ok = False
    return ok, rows
