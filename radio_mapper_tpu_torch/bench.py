"""Benchmark: full-pipeline IQ throughput per card, with MFU accounting.

Port of the JAX package's root ``bench.py``: ``python -m
radio_mapper_tpu_torch bench`` (or ``python -m radio_mapper_tpu_torch.bench``)
runs the flagship TDOA pipeline (K1 detect → K2 all-pairs GCC-PHAT → LM
solve) and its kernel legs on the card and prints ONE JSON line with the
reference's keys (:data:`RESULT_KEYS`); ``"backend"`` is the device type,
``"cuda"`` on the card. Every ``#`` line goes to stderr, the first of them
the card's ``nvidia-smi`` name and power limit.

Baseline: the north star is 256 simultaneous 2.4 MS/s channels on 16
devices, so one device's share is 16 ch × 2.4 MS/s = 38.4 M IQ samples/s
(:data:`BASELINE_SAMPLES_PER_S_PER_CHIP`, a demand figure, not a measured
speed of any device). ``vs_baseline`` > 1 means one card carries its share
with the whole detect + correlate + solve stack running.

Method, as the reference's: every timing is an epoch of ``iters`` queued
steps closed by ONE completion barrier (:func:`..device.completion_barrier`,
the port's stand-in for the reference's host fetch), elapsed/iters; the
channel sweep keeps the median of 5 epochs after dropping epochs over 2×
the fastest, the microbenches the median of 3. ``scan_blocks = K`` runs K
blocks a dispatch from a K-block stack materialized on the card (the
reference's ``lax.scan``; here a Python loop over the stack, so a rate is
per block). ``mfu`` is the analytic FLOP count of a block
(:func:`_analytic_step_flops`) over its time, over the card's FP32 peak
(:data:`PEAK_FLOPS_BY_DEVICE`); null on a card not in the table.

The legs, in the order :func:`main` runs them: the ingest loopback (paced
ring → pinned slot → copy → a sparse probe on the card); the channel sweep
64/128/256 ch (K1 → K2 a block); the forward FFT (K7 on [256, 16384]); the
all-pairs GCC (K3 → K2 on [32, 8, 17408]); pair EP at 64 buoys (K3 → K5 in a
one-rank process group); wideband config 4 (K3 → K5); the ingest ladder
32 → 8 → 1 ch, then 1 ch × 8 blocks at 1.3× pace (K1 → K2 a block).

Unlike the reference, no leg's failure is caught: a leg that raises ends
the run with a non-zero exit and no JSON line, and ``path="auto"`` is the
split path, with no retry on the complex one.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from radio_mapper_tpu_torch import device as device_mod
from radio_mapper_tpu_torch.ops import fft as fft_ops

# Per-device share of the north-star target (see the module docstring).
BASELINE_SAMPLES_PER_S_PER_CHIP = 38_400_000.0

# Peak FLOP/s by torch.cuda.get_device_name(), for MFU. The port's kernels
# and plain versions compute in FP32 outside the tensor cores, so the FP32
# peak is the denominator: NVIDIA's H100 SXM data sheet, 67 TFLOP/s dense
# FP32 at the card's 700 W power limit (the figure PERF.md's bounds use).
PEAK_FLOPS_BY_DEVICE = {
    "NVIDIA H100 80GB HBM3": 67e12,
}

# The JSON line's keys, in the reference's order.
RESULT_KEYS = (
    "metric", "value", "value_best_epoch", "unit", "vs_baseline", "mfu", "fft_ms_per_s",
    "pairs_per_s", "ep_pairs_per_s", "ingest_channels", "ingest_blocks_per_dispatch",
    "ingest_sustained_ms_per_s", "ingest_real_time_ratio", "ingest_dropped_bytes",
    "ingest_host_ms_per_step", "ingest_transfer_ms_per_step", "ingest_loopback_gb_per_s",
    "ingest_loopback_dropped_bytes", "ingest_loopback_host_ms", "wideband_ms_per_block",
    "wideband_pairs_per_s", "step_ms", "path", "backend",
)


def _log(msg: str):
    print(f"# {msg}", file=sys.stderr, flush=True)


def _stack(x: torch.Tensor, k: int) -> torch.Tensor:
    """``[k, *x.shape]``: k copies of ``x``, materialized on its device
    (the reference's ``broadcast_to(...) * 1.0``; an ``expand`` view would
    let every block read the same memory)."""
    return x.expand(k, *x.shape).contiguous()


def _build(num_buoys, block_len, sample_rate_hz, max_lag, device):
    """The flagship pipeline at the bench's settings (the channel count is
    the inputs' leading dim)."""
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline

    return TDOAPipeline(
        PipelineConfig(
            num_buoys=num_buoys,
            block_len=block_len,
            sample_rate_hz=sample_rate_hz,
            max_lag=max_lag,
            max_peaks=8,
            solver_iterations=25,
        ),
        device=device,
    )


def _epoch_time(step, args, *, iters: int, device: torch.device, warmup: int = 2) -> float:
    """Per-step wall time: ``max(warmup, 1)`` steps and a barrier, then
    ``iters`` steps closed by ONE completion barrier, elapsed/iters."""
    for _ in range(max(warmup, 1)):
        step(*args)
    device_mod.completion_barrier(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step(*args)
    device_mod.completion_barrier(device)
    return (time.perf_counter() - t0) / iters


def _median_epoch_time(step, args, *, iters: int, device: torch.device, epochs: int = 3) -> float:
    """Median of ``epochs`` barrier-closed epochs (2 warm-up steps before
    the first, 1 before each other)."""
    ts = [_epoch_time(step, args, iters=iters, device=device, warmup=2 if k == 0 else 1)
          for k in range(epochs)]
    return sorted(ts)[len(ts) // 2]


def _analytic_step_flops(num_channels, num_buoys, block_len, max_lag) -> float:
    """Analytic FLOP count of the split pipeline's dominant transform work
    (the reference's formula, kept as it is so the two packages' MFU share
    one numerator).

    One four-step DFT of length N = N1·N2 decomposed to real f32 matmuls
    costs 8·N·(N1+N2) mul-adds = 16·N·(N1+N2) FLOPs per transform.
    Per channel: B forward FFTs (nfft) + P inverse FFTs (nfft) + the
    detector reusing the correlation bins (free).
    """
    nfft = fft_ops.friendly_fft_len(block_len + max_lag)
    n1 = max(d for d in range(1, int(np.sqrt(nfft)) + 1) if nfft % d == 0 and d <= 1024)
    n2 = nfft // n1
    per_fft = 16.0 * nfft * (n1 + n2)
    pairs = num_buoys * (num_buoys - 1) // 2
    return num_channels * (num_buoys + pairs) * per_fft


def build_pipeline_step(
    *,
    num_channels: int = 32,
    num_buoys: int = 8,
    block_len: int = 16_384,
    sample_rate_hz: float = 2_400_000.0,
    max_lag: int = 512,
    path: str = "auto",  # auto (= split) | split | complex
    scan_blocks: int = 1,
    device="cuda",
):
    """One flagship step and its inputs on ``device``. Returns ``(name,
    step, args, flops_per_block)``.

    The inputs are ``example_inputs(batch=(num_channels,), seed=0)``, the
    reference's draws. ``scan_blocks = K > 1`` runs ``step_split_scan`` on
    a K-block stack of that block materialized on the device (the split
    path only); ``path="complex"`` runs ``step`` on ``complex(re, im)``.
    """
    if path not in ("auto", "split", "complex"):
        raise ValueError(f"unknown bench path {path!r}")
    dev = torch.device(device)
    pipe = _build(num_buoys, block_len, sample_rate_hz, max_lag, dev)
    re, im, anchors = pipe.example_inputs(batch=(num_channels,), seed=0)
    flops = _analytic_step_flops(num_channels, num_buoys, block_len, max_lag)
    if scan_blocks > 1:
        if path == "complex":
            raise ValueError("scan_blocks supports the split path only")
        return (f"split-scan{scan_blocks}", pipe.step_split_scan,
                (_stack(re, scan_blocks), _stack(im, scan_blocks), anchors), flops)
    if path == "complex":
        name, step, args = "complex", pipe.step, (torch.complex(re, im), anchors)
    else:
        name, step, args = "split", pipe.step_split, (re, im, anchors)
    t0 = time.perf_counter()
    step(*args)
    device_mod.completion_barrier(dev)
    _log(f"path {name!r}: first call {time.perf_counter() - t0:.1f}s")
    return name, step, args, flops


def run_pipeline_bench(*, num_channels: int = 32, iters: int = 10, device="cuda", **kwargs):
    """Build, then one timed epoch. Returns ``(samples/s, name,
    s_per_block, flops_per_block)``; with ``scan_blocks = K`` a dispatch
    is K blocks, and the rate counts all of them."""
    num_buoys = kwargs.get("num_buoys", 8)
    block_len = kwargs.get("block_len", 16_384)
    k = kwargs.get("scan_blocks", 1)
    dev = torch.device(device)
    name, step, args, flops = build_pipeline_step(num_channels=num_channels, device=dev, **kwargs)
    block_s = _epoch_time(step, args, iters=iters, device=dev, warmup=0) / k
    return num_channels * num_buoys * block_len / block_s, name, block_s, flops


def run_fft_microbench(*, rows: int = 256, n: int = 16_384, iters: int = 50, epochs: int = 3,
                       device="cuda") -> float:
    """Forward split-complex FFT throughput (complex samples/s):
    ``ops.fft.fft_re_im``, K7 on the card."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    re = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32)).to(dev)
    im = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32)).to(dev)
    dt = _median_epoch_time(fft_ops.fft_re_im, (re, im), iters=iters, epochs=epochs, device=dev)
    return rows * n / dt


def run_gcc_microbench(
    *, channels: int = 32, num_buoys: int = 8, n: int = 16_384, max_lag: int = 512,
    iters: int = 50, scan_blocks: int = 64, epochs: int = 3, device="cuda",
) -> float:
    """All-pairs GCC-PHAT throughput (pair correlations/s), ``scan_blocks``
    blocks a dispatch: the fused chain (K3 → K2) where the pipeline would
    route to it, else the natural-order split GCC."""
    import functools

    from radio_mapper_tpu_torch.ops import split_complex as sc_ops

    dev = torch.device(device)
    rng = np.random.default_rng(0)
    re = torch.from_numpy(rng.normal(size=(channels, num_buoys, n)).astype(np.float32)).to(dev)
    im = torch.from_numpy(rng.normal(size=(channels, num_buoys, n)).astype(np.float32)).to(dev)
    fn = (
        sc_ops.gcc_phat_all_pairs_split_fused
        if sc_ops.gcc_fused_enabled(n + max_lag, "phat")
        else sc_ops.gcc_phat_all_pairs_split
    )
    base = functools.partial(fn, sample_rate_hz=2_400_000.0, max_lag=max_lag)
    pairs = num_buoys * (num_buoys - 1) // 2
    if scan_blocks > 1:
        k = scan_blocks
        scan_step = lambda rK, iK: [base(r, i) for r, i in zip(rK, iK)]
        dt = _median_epoch_time(scan_step, (_stack(re, k), _stack(im, k)), iters=iters, epochs=epochs,
                                device=dev) / k
    else:
        dt = _median_epoch_time(base, (re, im), iters=iters, epochs=epochs, device=dev)
    return channels * pairs / dt


def _ep_inputs(num_buoys: int, block_len: int):
    """The EP leg's ``(re, im, anchors)`` as numpy, the reference's draws."""
    rng = np.random.default_rng(0)
    re = rng.normal(size=(num_buoys, block_len)).astype(np.float32)
    im = rng.normal(size=(num_buoys, block_len)).astype(np.float32)
    anchors = rng.normal(scale=5_000.0, size=(num_buoys, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    return re, im, anchors


def _ep_launches() -> dict:
    """The launch counts of the kernels an EP step can run."""
    from radio_mapper_tpu_torch.ops.cuda import fft_rows, gcc_pair

    return {
        "fft_rows_ct": fft_rows.launch_count,
        "gcc_pairs_onehot_lag_mags": gcc_pair.onehot_launch_count,
        "gcc_rows_lag_mags": gcc_pair.rows_launch_count,
    }


def _ep_rank(ctx, config, re, im, anchors, iters: int, scan_blocks: int, epochs: int) -> dict:
    """The EP leg in one rank of a one-rank "pair" mesh: pairs/s, and the
    kernel launches of every step the leg ran."""
    from radio_mapper_tpu_torch.parallel import mesh as mesh_lib
    from radio_mapper_tpu_torch.parallel.pair_ep import build_pair_ep_step

    mesh = mesh_lib.make_mesh((ctx.world_size,), ("pair",), device=ctx.device.type)
    step, specs, (pair_i, _) = build_pair_ep_step(mesh, config)
    to = lambda a, s: torch.from_numpy(np.ascontiguousarray(mesh_lib.local_block(a, mesh, s))).to(ctx.device)
    re_l, im_l, anc = (to(a, s) for a, s in zip((re, im, anchors), specs))
    before = _ep_launches()
    if scan_blocks > 1:
        k = scan_blocks
        scan_step = lambda rK, iK, a: [step(r, i, a) for r, i in zip(rK, iK)]
        dt = _median_epoch_time(scan_step, (_stack(re_l, k), _stack(im_l, k), anc), iters=iters,
                                epochs=epochs, device=ctx.device) / k
    else:
        dt = _median_epoch_time(step, (re_l, im_l, anc), iters=iters, epochs=epochs, device=ctx.device)
    after = _ep_launches()
    return {"pairs_per_s": len(pair_i) / dt,
            "launches": {name: after[name] - before[name] for name in after if after[name] != before[name]}}


def run_ep_microbench(
    *, num_buoys: int = 64, block_len: int = 4096, max_lag: int = 256,
    iters: int = 20, scan_blocks: int = 64, epochs: int = 3, device="cuda",
    launches: Optional[dict] = None,
) -> float:
    """Pair-EP step throughput (pair correlations/s): 64 receivers → 2016
    pairs on a one-rank "pair" mesh (``parallel.launch.run_ranks``: the
    mesh needs a process group), ``scan_blocks`` steps a dispatch. K3 →
    K5 on the card (K6 where ``gcc_pair.onehot_pairs_enabled`` says so).
    ``launches``, when given, gains the kernel launches the rank counted."""
    from radio_mapper_tpu_torch.parallel.launch import run_ranks
    from radio_mapper_tpu_torch.parallel.pair_ep import PairEPConfig

    cfg = PairEPConfig(num_buoys=num_buoys, block_len=block_len, max_lag=max_lag, solver_iterations=10)
    re, im, anchors = _ep_inputs(num_buoys, block_len)
    (res,) = run_ranks(_ep_rank, 1, device=torch.device(device).type,
                       args=(cfg, re, im, anchors, iters, scan_blocks, epochs))
    if launches is not None:
        for name, v in res["launches"].items():
            launches[name] = launches.get(name, 0) + int(v)
    return float(res["pairs_per_s"])


def run_wideband_bench(*, iters: int = 10, scan_blocks: int = 64, device="cuda", config=None):
    """Config 4: 64 buoys × 10 MS/s → 16-way polyphase channelizer →
    per-subchannel all-pairs GCC-PHAT (K3 → K5, 2016 pairs) → LM solve,
    ``scan_blocks`` blocks a dispatch. ``config`` defaults to
    ``WidebandConfig()``. Returns ``(ms_per_block, wide_samples_per_s,
    pairs_per_s)``."""
    from radio_mapper_tpu_torch.models.wideband import WidebandConfig, WidebandTDOAPipeline

    cfg = config or WidebandConfig()
    dev = torch.device(device)
    pipe = WidebandTDOAPipeline(cfg, device=dev)
    re, im, anchors = pipe.example_inputs(seed=0)
    if scan_blocks > 1:
        k = scan_blocks
        args = (_stack(re, k), _stack(im, k), anchors)
        step = lambda rK, iK, anc: [pipe.step_split(r, i, anc) for r, i in zip(rK, iK)]
    else:
        k, args, step = 1, (re, im, anchors), pipe.step_split
    t0 = time.perf_counter()
    step(*args)
    device_mod.completion_barrier(dev)
    _log(f"wideband config-4 first call {time.perf_counter() - t0:.1f}s")
    dt = _epoch_time(step, args, iters=iters, device=dev, warmup=1) / k
    return dt * 1e3, cfg.num_buoys * cfg.wide_block / dt, cfg.num_subchannels * cfg.num_pairs / dt


def run_ingest_bench(
    *, channels: int = 32, num_buoys: int = 8, block_len: int = 16_384,
    sample_rate_hz: float = 2_400_000.0, max_lag: int = 512, steps: int = 30,
    blocks_per_dispatch: int = 1, overdrive: float = 1.0, device="cuda",
):
    """Ingest-closed sustained throughput: native ring → pinned slot →
    copy → ``step_split_uint8`` (``step_split_uint8_scan`` with
    ``blocks_per_dispatch > 1``), paced at ``overdrive`` × real time for
    the benched channel count (channels × buoys × sample rate). Returns
    the ``IngestLoopStats``; ``dropped_bytes == 0`` means the pipeline
    kept up with the virtual SDR clock. ``real_time_ratio`` stays relative
    to the nominal rate."""
    from radio_mapper_tpu_torch.ingest.native import NativeIngest
    from radio_mapper_tpu_torch.ingest.runner import IngestLoop

    dev = torch.device(device)
    pipe = _build(num_buoys, block_len, sample_rate_hz, max_lag, dev)
    rng = np.random.default_rng(0)
    anchors = rng.normal(scale=8_000.0, size=(num_buoys, 3)).astype(np.float32)
    anchors[:, 2] = 0.0
    anchors = torch.from_numpy(np.broadcast_to(anchors, (channels, num_buoys, 3)).copy()).to(dev)
    rate_samples = channels * num_buoys * sample_rate_hz
    loop = IngestLoop.from_pipeline(pipe, None, channels=channels, anchors=anchors,
                                    blocks_per_dispatch=blocks_per_dispatch, source_samples_per_s=rate_samples)
    t0 = time.perf_counter()
    loop.warm_compile()
    _log(f"ingest u8-step first call {time.perf_counter() - t0:.1f}s")
    ring = 1 << max(24, (loop.block_bytes * 8).bit_length())  # ~8 dispatches of headroom
    ing = NativeIngest.open_synthetic_paced(1, bytes_per_s=overdrive * 2.0 * rate_samples, ring_bytes=ring)
    loop.ingest = ing
    try:
        return loop.run(num_steps=steps, warmup_steps=0)
    finally:
        ing.close()


def run_ingest_loopback_bench(
    *, channels: int = 32, num_buoys: int = 8, block_len: int = 16_384,
    sample_rate_hz: float = 2_400_000.0, steps: int = 60, drain_threads: int = 4,
    device="cuda",
):
    """The host ingest leg alone: paced ring → parallel C++ drain into a
    pinned slot → copy to ``device`` → a sparse probe of the copied bytes
    (the pipeline's compute belongs to the legs above). The reference ran
    it on JAX's CPU device to keep its remote link out; the card's host
    has PCIe, so here the copy is the real one."""
    from radio_mapper_tpu_torch.ingest.native import NativeIngest
    from radio_mapper_tpu_torch.ingest.runner import IngestLoop

    dev = torch.device(device)

    def consume(raw, _anchors):
        # every byte was copied (the hand-off under test); a sparse read keeps the reduce cheap
        return raw[..., ::4097].to(torch.float32).sum()

    rate_samples = channels * num_buoys * sample_rate_hz
    loop = IngestLoop(consume, None, channels=channels, num_buoys=num_buoys, block_len=block_len,
                      anchors=torch.zeros(1, device=dev), source_samples_per_s=rate_samples, device=dev,
                      drain_threads=drain_threads)
    loop.warm_compile()
    # 32 blocks of ring: real time is judged by the sustained drain; buffered slack is free
    ring = 1 << max(24, (loop.block_bytes * 32).bit_length())
    ing = NativeIngest.open_synthetic_paced(2, bytes_per_s=2.0 * rate_samples, ring_bytes=ring,
                                            chunk_bytes=1 << 18)
    loop.ingest = ing
    try:
        return loop.run(num_steps=steps, warmup_steps=0)
    finally:
        ing.close()


def main(
    *, device="cuda", sweep_epochs: int = 5, sweep_iters: int = 15, scan_blocks: Optional[int] = None,
    micro_epochs: int = 3, fft_iters: int = 50, gcc_iters: int = 50, gcc_scan_blocks: int = 64,
    ep_iters: int = 20, ep_scan_blocks: int = 64, wideband_iters: int = 10, wideband_scan_blocks: int = 64,
    ingest_steps: int = 30, loopback_steps: int = 60,
) -> None:
    """Run every leg in the reference's order and print the JSON line.

    The keywords are the legs' depths, at the reference's values by
    default (a shallower run measures the same paths less well);
    ``scan_blocks`` defaults to ``$BENCH_SCAN_BLOCKS`` or 64, capped at
    16 for 256 channels. ``$BENCH_GCC_FUSED`` (on|off|auto) forces the
    GCC pair-stage route (``split_complex.set_gcc_fused``).
    """
    dev, name = torch.device(device), None
    if dev.type == "cuda":
        card = device_mod.require_cuda()
        name = card.name
        _log(f"card {card.label()}")
    peak = PEAK_FLOPS_BY_DEVICE.get(name)
    if peak is None:
        _log(f"no peak FLOP/s known for {name or dev.type!r}: mfu is null")

    # The host leg first, before the heavy legs have touched the process.
    loopback = run_ingest_loopback_bench(steps=loopback_steps, device=dev)
    _log(
        f"ingest loopback 32ch: {loopback.sustained_samples_per_s * 2 / 1e9:.2f} GB/s "
        f"({loopback.real_time_ratio:.2f}x real time), dropped_bytes={loopback.dropped_bytes}, "
        f"host {loopback.host_read_ms_per_step:.2f} ms/step"
    )

    mode = os.environ.get("BENCH_GCC_FUSED")
    if mode:
        from radio_mapper_tpu_torch.ops import split_complex as sc_ops

        sc_ops.set_gcc_fused(mode)
        _log(f"GCC fused routing forced: {mode}")

    # Channel sweep, K blocks a dispatch; each config's headline is the
    # median of its epochs after dropping those over 2× the fastest.
    scan_k = scan_blocks if scan_blocks is not None else int(os.environ.get("BENCH_SCAN_BLOCKS", "64"))
    best = {"rate": 0.0}
    for ch in (64, 128, 256):
        ch_scan = min(scan_k, 16) if ch >= 256 else min(scan_k, 64)
        path, step, args, flops = build_pipeline_step(num_channels=ch, scan_blocks=ch_scan, device=dev)
        samples = ch_scan * ch * 8 * 16_384
        epochs = []
        for epoch in range(sweep_epochs):
            step_s = _epoch_time(step, args, iters=sweep_iters, device=dev, warmup=3 if epoch == 0 else 1)
            epochs.append((samples / step_s, step_s / ch_scan))
        del step, args
        epochs.sort()
        spread = (epochs[-1][0] - epochs[0][0]) / epochs[len(epochs) // 2][0]
        kept = [e for e in epochs if e[1] <= 2.0 * epochs[-1][1]]
        rate, blk_s = kept[len(kept) // 2]
        rate_best = epochs[-1][0]
        _log(f"channels={ch} x{ch_scan}blk: epoch spread {spread * 100:.1f}%, kept {len(kept)}/{len(epochs)}")
        _log(f"channels={ch}: trimmed median {rate / 1e6:.1f} MS/s/card "
             f"(best {rate_best / 1e6:.1f}, path={path}, {blk_s * 1e3:.2f} ms/block)")
        if rate > best["rate"]:
            best = {"rate": rate, "rate_best": rate_best, "path": path, "step_s": blk_s, "flops": flops}

    fft_rate = run_fft_microbench(iters=fft_iters, epochs=micro_epochs, device=dev)
    _log(f"fft microbench: {fft_rate / 1e6:.1f} M complex samples/s")
    gcc_rate = run_gcc_microbench(iters=gcc_iters, scan_blocks=gcc_scan_blocks, epochs=micro_epochs, device=dev)
    _log(f"gcc microbench: {gcc_rate:.0f} pair correlations/s (scan-{gcc_scan_blocks} amortized)")
    ep_rate = run_ep_microbench(iters=ep_iters, scan_blocks=ep_scan_blocks, epochs=micro_epochs, device=dev)
    _log(f"ep microbench: {ep_rate:.0f} EP pairs/s (64 buoys / 2016 pairs, scan-{ep_scan_blocks} amortized)")
    wb = run_wideband_bench(iters=wideband_iters, scan_blocks=wideband_scan_blocks, device=dev)
    _log(f"wideband config-4: {wb[0]:.1f} ms/block = {wb[1] / 1e6:.1f} wide MS/s "
         f"(64 buoys x 10 MS/s), {wb[2] / 1e3:.0f}k pairs/s")

    # Ingest-closed sustained run at real-time pace: halve the channels
    # until the loop keeps up, then 1 ch × 8 blocks a dispatch at 1.3×.
    ingest, ingest_channels, ingest_bpd = None, None, 1
    for try_channels in (32, 8, 1):
        st = run_ingest_bench(channels=try_channels, steps=ingest_steps, device=dev)
        _log(
            f"ingest {try_channels}ch: {st.sustained_samples_per_s / 1e6:.1f} MS/s sustained "
            f"({st.real_time_ratio:.2f}x real time), dropped_bytes={st.dropped_bytes}, "
            f"host {st.host_read_ms_per_step:.2f} ms + put {st.transfer_ms_per_step:.2f} ms /step"
        )
        ingest, ingest_channels = st, try_channels
        if st.dropped_bytes == 0 and st.real_time_ratio >= 0.95:
            break
    if ingest.real_time_ratio < 0.95:
        st = run_ingest_bench(channels=1, blocks_per_dispatch=8, overdrive=1.3, steps=ingest_steps, device=dev)
        _log(f"ingest 1ch x8blk-scan @1.3x pace: {st.sustained_samples_per_s / 1e6:.1f} MS/s "
             f"({st.real_time_ratio:.2f}x nominal), dropped_bytes={st.dropped_bytes}")
        if st.real_time_ratio > ingest.real_time_ratio:
            ingest, ingest_channels, ingest_bpd = st, 1, 8

    mfu = None
    if peak is not None:
        achieved = best["flops"] / best["step_s"]
        mfu = achieved / peak
        _log(f"MFU: {best['flops'] / 1e9:.2f} GFLOP/block / {best['step_s'] * 1e3:.2f} ms "
             f"= {achieved / 1e12:.2f} TFLOP/s = {mfu * 100:.1f}% of {peak / 1e12:.0f} TF peak")

    value = best["rate"]  # every leg ran: no key is null but mfu off the table's cards
    line = {
        "metric": "iq_samples_per_s_per_chip",
        "value": round(float(value), 1),  # median of epochs
        "value_best_epoch": round(float(best["rate_best"]), 1),
        "unit": "samples/s/chip",
        "vs_baseline": round(value / BASELINE_SAMPLES_PER_S_PER_CHIP, 4),
        "mfu": round(mfu, 4) if mfu is not None else None,
        "fft_ms_per_s": round(fft_rate / 1e6, 1),
        "pairs_per_s": round(gcc_rate, 1),
        "ep_pairs_per_s": round(ep_rate, 1),
        "ingest_channels": ingest_channels,
        "ingest_blocks_per_dispatch": ingest_bpd,
        "ingest_sustained_ms_per_s": round(ingest.sustained_samples_per_s / 1e6, 1),
        "ingest_real_time_ratio": round(ingest.real_time_ratio, 3),
        "ingest_dropped_bytes": ingest.dropped_bytes,  # bytes; 2 a sample
        "ingest_host_ms_per_step": round(ingest.host_read_ms_per_step, 3),
        "ingest_transfer_ms_per_step": round(ingest.transfer_ms_per_step, 3),
        "ingest_loopback_gb_per_s": round(loopback.sustained_samples_per_s * 2 / 1e9, 3),
        "ingest_loopback_dropped_bytes": loopback.dropped_bytes,
        "ingest_loopback_host_ms": round(loopback.host_read_ms_per_step, 3),
        "wideband_ms_per_block": round(wb[0], 2),
        "wideband_pairs_per_s": round(wb[2], 1),
        "step_ms": round(best["step_s"] * 1e3, 3),
        "path": best["path"],
        "backend": dev.type,
    }
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
