#!/usr/bin/env python3
"""One run of the PyTorch/CUDA port's flagship path on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``radio_mapper_tpu_torch/csrc`` (nvcc,
sm_90a), then:

1. prints the card's name and power limit and the kernel build time;
2. K1 (fused FFT + detect) vs its plain PyTorch version at the flagship
   shape [1024 rows, 17408], with errors and median CUDA-event times;
3. K2 (PHAT pair stage) vs its plain version at [128, 8, 17408] →
   [128, 28, 1025], fed K1's outputs;
4. a simulated scene (4 buoys, 16384 samples, max_lag 600) through
   ``TDOAPipeline.step_split`` on the card: the fix must land within
   50 m and agree with the port's CPU run;
5. the full width — 8 blocks of 128 channels × 8 buoys × 16384 uint8 IQ
   at 2.4 MS/s, max_lag 512 — through ``step_split_uint8_scan``, with
   both kernels' launch counts, ms/block, IQ samples/s and a per-stage
   split from CUDA events.

Any failed check raises, so the run exits non-zero and prints no result
line. The last two lines are a JSON object describing the kernels and,
last, ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero at once.
"""

from __future__ import annotations

import json
import statistics
import sys
import time


def _cuda_ms(torch, fn, reps=5):
    """Median milliseconds of ``fn()`` on the current stream (CUDA events,
    after one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _leaves(torch, x):
    """The tensors of a (nested) NamedTuple of tensors."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x for t in _leaves(torch, f)]


def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import numpy as np
    import torch

    from radio_mapper_tpu_torch import device, sim
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline
    from radio_mapper_tpu_torch.ops import ct_plan, gcc_phat, iq
    from radio_mapper_tpu_torch.ops.cuda import build, fft_detect, gcc_pair

    card = device.require_cuda()
    tag = card.label()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the plain versions are the FP32 comparison: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: card and build
    print(card.smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {card.name} count {card.count}")
    t0 = time.perf_counter()
    build.library()
    print(f"phase 1: kernels built+loaded in {time.perf_counter() - t0:.2f} s {tag}")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- phase 2: K1 vs plain at the flagship shape
    fs, n, lag, chans, buoys = 2_400_000.0, 16_384, 512, 128, 8
    nfft = ct_plan.plan_nfft(n + lag)
    plan = ct_plan.detect_plan(
        nfft, sample_rate_hz=fs, threshold_db=-70.0, min_distance_bins=10,
        dc_notch_hz=10_000.0, confidence_floor=0.3, snr_fullscale_db=20.0,
    )
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 256, size=(chans, buoys, 2 * n), dtype=np.uint8)).to(dev)
    re, im = iq.decode_uint8_split(raw)
    pad = lambda a: torch.nn.functional.pad(a, (0, nfft - n)).reshape(-1, nfft).contiguous()
    xr, xi = pad(re), pad(im)
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    p1 = fft_detect.fft_detect_rows_ct_plain(xr, xi, plan)
    torch.cuda.synchronize()
    fr, fi, score, arg, nf, rmax = k1
    pfr, pfi, pscore, parg, pnf, prmax = p1
    row_mag = torch.sqrt(prmax).unsqueeze(-1)
    spec_abs = max((fr - pfr).abs().max().item(), (fi - pfi).abs().max().item())
    spec_rel = max(((fr - pfr).abs() / row_mag).max().item(), ((fi - pfi).abs() / row_mag).max().item())
    nf_err = (nf - pnf).abs().max().item()
    rmax_rel = ((rmax - prmax).abs() / prmax).max().item()
    fin, pfin = torch.isfinite(score), torch.isfinite(pscore)
    both = fin & pfin
    pattern_diff = (fin != pfin).float().mean().item()
    arg_diff = (arg != parg)[both].float().mean().item()
    score_rel = ((score - pscore).abs() / prmax.unsqueeze(-1))[both].max().item()
    k1_ms = _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct(xr, xi, plan))
    k1_plain_ms = _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct_plain(xr, xi, plan))
    print(
        f"phase 2: K1 [{xr.shape[0]}, {nfft}] spectra max|err| {spec_abs:.3e} "
        f"(rel to row max|X| {spec_rel:.3e}, tol 1e-4), noise floor {nf_err:.3e} dB (tol 1e-3), "
        f"row_max rel {rmax_rel:.3e} (tol 1e-5), candidate pattern differs {pattern_diff:.2e} "
        f"of segments, argmax differs {arg_diff:.2e} (tol 1e-3 each), score rel {score_rel:.3e} "
        f"(tol 1e-4); kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms {tag}"
    )
    _require(spec_rel <= 1e-4, f"K1 spectra disagree: {spec_rel}")
    _require(nf_err <= 1e-3, f"K1 noise floor disagrees: {nf_err}")
    _require(rmax_rel <= 1e-5, f"K1 row max disagrees: {rmax_rel}")
    _require(pattern_diff <= 1e-3 and arg_diff <= 1e-3, "K1 detect partials disagree")
    _require(score_rel <= 1e-4, f"K1 segment scores disagree: {score_rel}")
    _require(both.any().item(), "K1 produced no candidates to compare")

    # ---- phase 3: K2 vs plain, fed K1's outputs
    pi, pj = gcc_phat.pair_indices(buoys)
    sre, sim_ = fr.view(chans, buoys, nfft), fi.view(chans, buoys, nfft)
    smax = rmax.view(chans, buoys)
    k2 = gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, max_lag=lag)
    p2 = gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, smax, pi, pj, max_lag=lag)
    torch.cuda.synchronize()
    win_abs = (k2 - p2).abs().max().item()
    win_rel = ((k2 - p2).abs().amax(-1) / p2.abs().amax(-1)).max().item()
    k2_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, max_lag=lag))
    k2_plain_ms = _cuda_ms(
        torch, lambda: gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, smax, pi, pj, max_lag=lag)
    )
    print(
        f"phase 3: K2 [{chans}, {buoys}, {nfft}] -> {list(k2.shape)} window max|err| {win_abs:.3e} "
        f"(rel to window max {win_rel:.3e}, tol 1e-4); kernel {k2_ms:.3f} ms, plain "
        f"{k2_plain_ms:.3f} ms {tag}"
    )
    _require(tuple(k2.shape) == (chans, len(pi), 2 * lag + 1), "K2 output shape")
    _require(win_rel <= 1e-4, f"K2 lag windows disagree: {win_rel}")
    del k1, p1, k2, p2, fr, fi, score, arg, pfr, pfi, pscore, parg, xr, xi, re, im, raw

    # ---- phase 4: a simulated scene, fixed on the card and on the CPU
    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8)
    cap = sim.synthesize(scen)
    cfg = PipelineConfig(num_buoys=4, block_len=scen.block_len, sample_rate_hz=scen.sample_rate_hz,
                         max_lag=600, power_offset_db=40.0)
    host = [torch.from_numpy(a.astype(np.float32)) for a in (cap.iq.real, cap.iq.imag, cap.buoy_enu)]
    on_card = TDOAPipeline(cfg, device=dev).step_split(*(a.to(dev) for a in host))
    on_cpu = TDOAPipeline(cfg, device="cpu").step_split(*host)
    pos = on_card.fix.position_enu.cpu().numpy()
    err_m = float(np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]))
    lag_gap = (on_card.correlation.lag_samples.cpu() - on_cpu.correlation.lag_samples).abs().max().item()
    fix_gap = float(np.abs(pos - on_cpu.fix.position_enu.numpy()).max())
    print(
        f"phase 4: scene fix error {err_m:.3f} m (limit 50), card vs CPU: lags {lag_gap:.2e} "
        f"samples (tol 1e-3), fix {fix_gap:.3e} m (tol 0.5) {tag}"
    )
    _require(err_m < 50.0, f"scene fix error {err_m} m")
    _require(lag_gap <= 1e-3 and fix_gap <= 0.5, "card and CPU runs disagree")

    # ---- phase 5: full width, 8 blocks through the scan entry point
    blocks = 8
    cfg = PipelineConfig(num_buoys=buoys, block_len=n, sample_rate_hz=fs, max_lag=lag)
    pipe = TDOAPipeline(cfg, device=dev)
    raw, anchors = pipe.example_inputs(batch=(blocks, chans), seed=0, uint8=True)
    anchors = anchors[0]
    pipe.step_split_uint8(raw[0], anchors)  # warm-up: tables, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fft_detect.launch_count = 0
    gcc_pair.launch_count = 0
    t0 = time.perf_counter()
    out = pipe.step_split_uint8_scan(raw, anchors)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fft_detect_rows_ct": fft_detect.launch_count, "gcc_pair_lag_mags": gcc_pair.launch_count}
    leaves = _leaves(torch, out)
    finite = all(torch.isfinite(x).all().item() for x in leaves if x.is_floating_point())
    ms_block = 1e3 * wall / blocks
    samples_s = blocks * chans * buoys * n / wall
    print(
        f"phase 5: {blocks} blocks x {chans} ch x {buoys} buoys x {n} uint8 IQ: {ms_block:.3f} ms/block, "
        f"{samples_s:.4e} IQ samples/s, peak mem {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
        f"launches {launches}, all finite {finite} {tag}"
    )
    _require(out.fix.position_enu.shape == (blocks, chans, 3), "scan output shape")
    _require(finite, "non-finite outputs at full width")
    _require(all(v == blocks for v in launches.values()), f"kernel launches {launches}")

    names = ["decode", "pad", "fft_detect", "peaks", "gcc_pair", "lag_peaks", "solve"]
    splits = {k: [] for k in names}
    for _ in range(3):
        events = []

        def mark(name, events=events):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        mark("start")
        pipe.step_split_uint8(raw[0], anchors, on_stage=mark)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(events, events[1:]):
            splits[name].append(a.elapsed_time(b))
    med = {k: statistics.median(v) for k, v in splits.items()}
    stage = {
        "decode+pad": med["decode"] + med["pad"],
        "K1 fft_detect": med["fft_detect"],
        "top-K tail": med["peaks"],
        "K2 gcc_pair": med["gcc_pair"],
        "lag peaks": med["lag_peaks"],
        "weights+solve": med["solve"],
    }
    print(
        "phase 5: stage split ms/block (median of 3, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + f", sum {sum(stage.values()):.3f} {tag}"
    )

    print(json.dumps({"kernels": [
        {
            "name": "fft_detect_rows_ct",
            "route": "cuda",
            "source": "radio_mapper_tpu_torch/csrc/fft_detect.cu",
            "replaces": "radio_mapper_tpu/ops/pallas/detect_kernel.py:443",
            "launches": launches["fft_detect_rows_ct"],
            "max_abs_err": spec_abs,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
        },
        {
            "name": "gcc_pair_lag_mags",
            "route": "cuda",
            "source": "radio_mapper_tpu_torch/csrc/gcc_pair.cu",
            "replaces": "radio_mapper_tpu/ops/pallas/gcc_kernel.py:358",
            "launches": launches["gcc_pair_lag_mags"],
            "max_abs_err": win_abs,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card.name, "count": card.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
