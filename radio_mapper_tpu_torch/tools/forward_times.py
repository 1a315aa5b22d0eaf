"""Time the forward FFT + detect kernels back to back: K1, K3, K4 and K8.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 -m radio_mapper_tpu_torch.tools.forward_times

It builds the package's kernels and times, through the package's own
wrappers, K1 (``fft_detect``) at the card tests' shape [16, 9216] (the
``entry()`` length) and at the flagship shape [1024, 17408], K3
(``fft_rows_ct``) and K4 (``detect_ct``) on the same rows, and K8
(``channel_step``) at [128, 8, 17408] with max_lag 512: the mean of 20
back-to-back launches between two CUDA events, median of 3, so the host's
time to call the wrapper overlaps the card's work. K1 less K3 is what K1
spends past the transform: the power hand-off and the detect body. Then
K1, K3 and K4 on rows past one block's shared memory, [1024, 33792],
[1024, 34816] (n1 = 256), [1024, 66560] and the mixed-radix row passes
[1024, 58368], [512, 87040], [1024, 97280] and [256, 121856] (n1 = 384,
640, 896), which
run the long-row designs (a checkout without them prints that the wrapper
raises), and
the long-row K3 and K1 forced onto [1024, 17408] beside the one-block ones
(and K1 through the route, its cluster design where the checkout has it);
K7 (``fft_natural``) on its rows of 32768 and 65536 points, [32, 32768],
[8, 65536], [8192, 32768] and [4096, 65536], with the design that ran.
Last, one line of digests: SHA-256 of the outputs on seeded rows up to
17408, K3 at every instantiation of the one-block design a length up to
24576 reaches (a ∈ {1, 2, 4, 8}, step B in registers or streamed), K1 at
5120, 9216 and 17408, K4 at 9216 and 17408, K8 at [16, 8, 5120] (max_lag
256), [16, 8, 9216] and [128, 8, 17408] (max_lag 512); then one line of the
long rows' digests: K3, K4 on K3's spectra, K1 and K8 (max_lag 600) on
[16, 8, n] at n = 33792, 34816, 58368, 66560, 87040, 97280 and 121856
(every n1 of the long K3 and cluster sizes 2, 4, 8; K8's on a line of its
own). Equal digests from two checkouts in one call mean equal outputs bit
for bit. A third line: K2
(each gate), K5, K6 and K8 at n1 = 128 (5120, 17408) and 256 (34816).

``--pair`` times only the pair kernels: at n1 = 128 K2 at [128, 8,
17408] (the flagship's default shape, max_lag 512), K5 at [16, 64, 5120]
(the wideband block, max_lag 128; also one pair a block where the
checkout has K5's tiles), K6 at [2016, 5120] × 4 and K8 at [128, 8, 17408];
then K2 at [128, 8, 58368] (the flagship at block_len 57344, n1 = 384)
and [8, 8, 121856] (n1 = 896) and K5 at [1, 64, 58368]; then it prints
the pair digests. ``--k1`` times only K1 and K3 at [1024,
58368] (n1 = 384: the wide design, K1 in one launch), then prints the
long rows' digests; ``--k1 17408,33792,34816,66560,97280`` times them at
the lengths named instead (rows by length, :data:`K1_ROWS`: 1024 at these,
[256, 121856]); K1 at n1 = 128/256 is its cluster design, one launch
(a checkout before it: the one-block K1 up to 24576, the cluster K3 then
K4 above). ``--topk K`` with ``--k1`` also times K1 with ``emit_topk =
K`` (the in-kernel top-K, T1) at each length, with the design that ran:
one launch of the cluster or wide design, or, in a checkout before it,
the one-block K1 up to 24576 and the long K3 then K4 above. The long
rows' digest line holds K1's top-K blocks at K = 8 too, so two
checkouts' T1 designs are compared bit for bit.

The wrappers' signatures are those of every version since K8 was ported,
so with ``PYTHONPATH`` at another checkout it times that checkout's
kernels. Run this file by its path (``python3
radio_mapper_tpu_torch/tools/forward_times.py``) to time another
checkout with this version of the script.
"""

from __future__ import annotations

import hashlib
import statistics
import sys

import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan, gcc_phat
from radio_mapper_tpu_torch.ops.cuda import (build, channel_step, detect_ct, fft_detect, fft_natural, fft_rows,
                                             gcc_pair)

LONG_DIGEST_N = (33_792, 34_816, 58_368, 66_560, 87_040, 97_280, 121_856)  # the long K3's n1 and cluster classes
# --k1's rows a length: the flagship's 128 ch x 8 buoys at block_len 16384,
# 32768 (max_lag 600 and 2048), 65536, 57344 and 96000, and the long rows of
# PERF.md's K3 table at 87040, 121856
K1_ROWS = {17_408: 1024, 33_792: 1024, 34_816: 1024, 66_560: 1024, 58_368: 1024, 97_280: 1024, 87_040: 512,
           117_760: 256, 128_000: 256, 121_856: 256}
DETECT = dict(sample_rate_hz=2_400_000.0, threshold_db=-70.0, min_distance_bins=10,
              dc_notch_hz=10_000.0, confidence_floor=0.3, snr_fullscale_db=20.0)


def _mean_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _digests(dev, tag, short=True) -> None:
    """The digest lines: the rows up to 17408 (``short``), then the long rows."""
    g = torch.Generator(device=dev).manual_seed(1)
    rows = lambda *shape: 40.0 * torch.randn(*shape, device=dev, generator=g)
    if short:
        _short_digests(tag, rows)
    out = {"K3": [], "K1": [], "K4": [], "K1 top-K 8": []}
    k8 = []  # K8's long design: the long K1, then K2's launch
    pi, pj = gcc_phat.pair_indices(8)
    for nfft in LONG_DIGEST_N:
        plan = ct_plan.detect_plan(nfft, **DETECT)
        xr, xi = rows(16, 8, nfft), rows(16, 8, nfft)
        fr, fi = fft_rows.fft_rows_ct(xr.view(-1, nfft), xi.view(-1, nfft))
        out["K3"] += (fr, fi)
        out["K4"] += detect_ct.detect_ct_partials(fr, fi, plan)
        out["K1"] += fft_detect.fft_detect_rows_ct(xr.view(-1, nfft), xi.view(-1, nfft), plan)
        out["K1 top-K 8"] += fft_detect.fft_detect_rows_ct(xr.view(-1, nfft), xi.view(-1, nfft), plan, emit_topk=8)
        k8.extend(channel_step.channel_step_partials(xr, xi, pi, pj, plan, 600))
        del xr, xi, fr, fi
    print(f"long digests ({', '.join(map(str, LONG_DIGEST_N))}): "
          + ", ".join(f"{k} {_digest(v)}" for k, v in out.items()) + f" {tag}")
    print(f"K8 long design digest (the same lengths): {_digest(k8)} {tag}")


def _short_digests(tag, rows) -> None:
    out = {"K3": [], "K1": [], "K4": [], "K8": []}
    for n2 in (5, 9, 17, 25, 10, 18, 34, 50, 20, 36, 68, 100, 40, 72, 136):  # (a, r) of every K3 instantiation
        out["K3"] += fft_rows.fft_rows_ct(rows(64, 128 * n2), rows(64, 128 * n2))
    for nfft in (5120, 9216, 17408):
        plan = ct_plan.detect_plan(nfft, **DETECT)
        xr, xi = rows(128, 8, nfft), rows(128, 8, nfft)
        out["K1"] += fft_detect.fft_detect_rows_ct(xr.view(-1, nfft), xi.view(-1, nfft), plan)
        if nfft > 5120:
            out["K4"] += detect_ct.detect_ct_partials(*fft_rows.fft_rows_ct(xr.view(-1, nfft), xi.view(-1, nfft)), plan)
        c = 128 if nfft == 17408 else 16
        pi, pj = gcc_phat.pair_indices(8)
        lag = 256 if nfft == 5120 else 512  # K8's pair buffers take max_lag ≤ 256 at 5120
        out["K8"] += channel_step.channel_step_partials(xr[:c], xi[:c], pi, pj, plan, lag)
    print("digests: " + ", ".join(f"{k} {_digest(v)}" for k, v in out.items()) + f" {tag}")


def pair_digests(dev) -> dict:
    """K2 (every gate), K5, K6 and K8 at n1 = 128 (5120, 17408) and 256
    (34816; K8 there is its long design, K1 then K2): one digest each."""
    g = torch.Generator(device=dev).manual_seed(2)
    rows = lambda *shape: torch.randn(*shape, device=dev, generator=g)
    out = {"K2": [], "K5": [], "K6": [], "K8": []}
    pi, pj = gcc_phat.pair_indices(8)
    for nfft, lag in ((5120, 128), (17408, 512), (34816, 512)):  # n1 = 128, 128, 256
        sre, sim, smax = rows(16, 8, nfft), rows(16, 8, nfft), rows(16, 8).abs() + 1.0
        for gate in ("l2rx", "l2", "l1"):
            gcc_pair.set_phat_gate(gate)
            try:
                out["K2"].append(gcc_pair.gcc_pair_lag_mags(sre, sim, smax, pi, pj, max_lag=lag))
            finally:
                gcc_pair.set_phat_gate("l2rx")
        out["K2"].append(gcc_pair.gcc_pair_lag_mags(sre, sim, smax, pi, pj, max_lag=lag, weighting="cc"))
        s2 = (smax[:, pi] * smax[:, pj]).contiguous()
        out["K5"].append(gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim, pi, pj, max_lag=lag, s2=s2))
        gather = lambda x, idx: x[0][torch.as_tensor(idx, device=dev)].contiguous()
        xr, xi, yr, yi = gather(sre, pi), gather(sim, pi), gather(sre, pj), gather(sim, pj)
        out["K6"].append(gcc_pair.gcc_rows_lag_mags(xr, xi, yr, yi, max_lag=lag, s2=s2[0].contiguous()))
        if nfft > 5120:
            plan = ct_plan.detect_plan(nfft, **DETECT)
            out["K8"] += channel_step.channel_step_partials(40.0 * sre, 40.0 * sim, pi, pj, plan, lag)
    return {k: _digest(v) for k, v in out.items()}


def pair_main(dev, tag) -> None:
    """``--pair``: the pair kernels at n1 = 128 on the flagship's and the
    wideband block's shapes (K2, K5, K6, K8), K2 at the flagship's
    block_len-57344 shape [128, 8, 58368] (n1 = 384, max_lag 600, l2rx),
    at [8, 8, 121856] (n1 = 896) and K5 at [1, 64, 58368], then the pair
    digests at n1 = 128 and 256."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g)
    pi, pj = gcc_phat.pair_indices(8)
    wpi, wpj = gcc_phat.pair_indices(64)
    sre, sim, smax = rnd(128, 8, 17_408), rnd(128, 8, 17_408), rnd(128, 8).abs() + 1.0
    t2 = _mean_ms(lambda: gcc_pair.gcc_pair_lag_mags(sre, sim, smax, pi, pj, max_lag=512))
    plan = ct_plan.detect_plan(17_408, **DETECT)
    xr, xi = 40.0 * sre, 40.0 * sim
    t8 = _mean_ms(lambda: channel_step.channel_step_partials(xr, xi, pi, pj, plan, 512))
    print(f"[128, 8, 17408], max_lag 512: K2 {t2:.4f} ms, K8 {t8:.4f} ms {tag}")
    del sre, sim, xr, xi
    w_re, w_im = rnd(16, 64, 5120), rnd(16, 64, 5120)
    s2 = rnd(16, len(wpi)).abs() + 1.0
    k5 = lambda: gcc_pair.gcc_pairs_onehot_lag_mags(w_re, w_im, wpi, wpj, max_lag=128, s2=s2)
    t5 = {"K5": _mean_ms(k5)}
    if hasattr(gcc_pair, "TILE_PAIRS"):  # K5 in the tile kernel: also one pair a block
        t5["K5 (one pair a block)"] = _mean_ms(lambda: gcc_pair._launch_tiles(
            "K5", w_re, w_im, s2, wpi, wpj, 128, 0.05, "l2rx", 1))
    rows = [rnd(len(wpi), 5120) for _ in range(4)]
    t6 = _mean_ms(lambda: gcc_pair.gcc_rows_lag_mags(*rows, max_lag=128, s2=s2[0].contiguous()))
    print("[16, 64, 5120], max_lag 128: " + ", ".join(f"{k} {v:.4f} ms" for k, v in t5.items())
          + f"; K6 [2016, 5120] x 4 {t6:.4f} ms {tag}")
    del w_re, w_im, rows
    for c, nfft in ((128, 58_368), (8, 121_856)):
        sre, sim = rnd(c, 8, nfft), rnd(c, 8, nfft)
        smax = torch.rand(c, 8, device=dev, generator=g) + 1.0
        t2 = _mean_ms(lambda: gcc_pair.gcc_pair_lag_mags(sre, sim, smax, pi, pj, max_lag=600))
        print(f"[{c}, 8, {nfft}], max_lag 600: K2 {t2:.4f} ms {tag}")
        del sre, sim
    sre, sim = rnd(1, 64, 58_368), rnd(1, 64, 58_368)
    s2 = torch.rand(1, len(wpi), device=dev, generator=g) + 1.0
    t5 = _mean_ms(lambda: gcc_pair.gcc_pairs_onehot_lag_mags(sre, sim, wpi, wpj, max_lag=600, s2=s2))
    print(f"[1, 64, 58368], max_lag 600: K5 {t5:.4f} ms {tag}")
    del sre, sim
    print("pair digests (n1 = 128, 256): " + ", ".join(f"{k} {v}" for k, v in pair_digests(dev).items()) + f" {tag}")


def k1_main(dev, tag, lengths=(58_368,), topk=0) -> None:
    """``--k1``: K1 and K3 at [rows, nfft] for each length (rows
    :data:`K1_ROWS`, 1024 for a length it does not name; the detect plan of
    :data:`DETECT`), by default the flagship's block_len-57344 rows [1024,
    58368] (n1 = 384), and with ``topk`` K1 with ``emit_topk = topk`` on
    the same rows; then the long rows' digests."""
    g = torch.Generator(device=dev).manual_seed(0)
    for nfft in lengths:
        rows = K1_ROWS.get(nfft, 1024)
        plan = ct_plan.detect_plan(nfft, **DETECT)
        xr = 40.0 * torch.randn(rows, nfft, device=dev, generator=g)
        xi = 40.0 * torch.randn(rows, nfft, device=dev, generator=g)
        t1 = _mean_ms(lambda: fft_detect.fft_detect_rows_ct(xr, xi, plan))
        t3 = _mean_ms(lambda: fft_rows.fft_rows_ct(xr, xi))
        print(f"[{rows}, {nfft}], n1 = {ct_plan.ct_split(nfft)[0]}: K1 {t1:.4f} ms, K3 {t3:.4f} ms {tag}")
        if topk:
            tk = _mean_ms(lambda: fft_detect.fft_detect_rows_ct(xr, xi, plan, emit_topk=topk))
            print(f"[{rows}, {nfft}], n1 = {ct_plan.ct_split(nfft)[0]}: K1 top-K {topk} {tk:.4f} ms "
                  f"({fft_detect.geometry(nfft, emit_topk=topk)}) {tag}")
        del xr, xi
        torch.cuda.empty_cache()
    _digests(dev, tag, short=False)


def main() -> int:
    card = device.require_cuda()
    tag = card.label()
    print(card.smi)
    dev = torch.device("cuda", 0)
    build.library()
    if "--pair" in sys.argv[1:]:
        pair_main(dev, tag)
        return 0
    if "--k1" in sys.argv[1:]:
        i = sys.argv.index("--k1")
        named = sys.argv[i + 1] if i + 1 < len(sys.argv) and not sys.argv[i + 1].startswith("-") else None
        topk = int(sys.argv[sys.argv.index("--topk") + 1]) if "--topk" in sys.argv[1:] else 0
        k1_main(dev, tag, tuple(int(n) for n in named.split(",")) if named else (58_368,), topk)
        return 0
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, nfft in ((16, 9216), (1024, 17408)):
        plan = ct_plan.detect_plan(nfft, **DETECT)
        xr = 40.0 * torch.randn(rows, nfft, device=dev, generator=g)
        xi = 40.0 * torch.randn(rows, nfft, device=dev, generator=g)
        fr, fi = fft_rows.fft_rows_ct(xr, xi)
        t1 = _mean_ms(lambda: fft_detect.fft_detect_rows_ct(xr, xi, plan))
        t3 = _mean_ms(lambda: fft_rows.fft_rows_ct(xr, xi))
        t4 = _mean_ms(lambda: detect_ct.detect_ct_partials(fr, fi, plan))
        print(f"[{rows}, {nfft}]: K1 {t1:.4f} ms, K3 {t3:.4f} ms, K4 {t4:.4f} ms, K1 - K3 {t1 - t3:.4f} ms {tag}")
    c, b, lag = 128, 8, 512
    pi, pj = gcc_phat.pair_indices(b)
    x8r, x8i = xr.view(c, b, nfft), xi.view(c, b, nfft)
    t8 = _mean_ms(lambda: channel_step.channel_step_partials(x8r, x8i, pi, pj, plan, lag))
    print(f"[{c}, {b}, {nfft}], max_lag {lag}: K8 {t8:.4f} ms {tag}")
    del x8r, x8i
    for rows, nfft in ((1024, 33_792), (1024, 34_816), (1024, 66_560), (1024, 58_368), (512, 87_040),
                       (1024, 97_280), (256, 121_856)):
        plan = ct_plan.detect_plan(nfft, **DETECT)
        xr = 40.0 * torch.randn(rows, nfft, device=dev, generator=g)
        xi = 40.0 * torch.randn(rows, nfft, device=dev, generator=g)
        try:
            fr, fi = fft_rows.fft_rows_ct(xr, xi)
        except ValueError as e:
            print(f"[{rows}, {nfft}]: K3 raises: {e}")
            continue
        t1 = _mean_ms(lambda: fft_detect.fft_detect_rows_ct(xr, xi, plan))
        t3 = _mean_ms(lambda: fft_rows.fft_rows_ct(xr, xi))
        t4 = _mean_ms(lambda: detect_ct.detect_ct_partials(fr, fi, plan))
        print(f"[{rows}, {nfft}] ({'·'.join(map(str, ct_plan.ct_split(nfft)))}), long rows: K1 {t1:.4f} ms, "
              f"K3 {t3:.4f} ms, K4 {t4:.4f} ms {tag}")
        del xr, xi, fr, fi
    if hasattr(fft_rows, "fft_rows_ct_long"):
        rows, nfft = 1024, 17_408
        plan = ct_plan.detect_plan(nfft, **DETECT)
        xr = 40.0 * torch.randn(rows, nfft, device=dev, generator=g)
        xi = 40.0 * torch.randn(rows, nfft, device=dev, generator=g)
        block = getattr(fft_detect, "block_detect", None)  # the one-block K1 where the route takes another
        times = {
            "K1": _mean_ms(lambda: fft_detect.fft_detect_rows_ct(xr, xi, plan)),
            **({"K1 block": _mean_ms(lambda: block(xr, xi, plan))} if block else {}),
            "K1 long": _mean_ms(lambda: fft_detect.fft_detect_rows_ct_long(xr, xi, plan)),
            "K3 block": _mean_ms(lambda: fft_rows.fft_rows_ct(xr, xi)),
            "K3 long": _mean_ms(lambda: fft_rows.fft_rows_ct_long(xr, xi)),
        }
        print(f"[{rows}, {nfft}], long designs forced: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + f" {tag}")
    for rows, n in ((32, 32_768), (8, 65_536), (8192, 32_768), (4096, 65_536)):
        xr = torch.randn(rows, n, device=dev, generator=g)
        xi = torch.randn(rows, n, device=dev, generator=g)
        t7 = _mean_ms(lambda: fft_natural.fft_rows(xr, xi))
        print(f"[{rows}, {n}]: K7 {t7:.4f} ms ({fft_natural.design(n)}) {tag}")
        del xr, xi
        torch.cuda.empty_cache()
    _digests(dev, tag)
    print("pair digests (n1 = 128, 256): " + ", ".join(f"{k} {v}" for k, v in pair_digests(dev).items()) + f" {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
