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
spends past the transform: the power hand-off and the detect body. The
wrappers' signatures are those of every version since K8 was ported, so
with ``PYTHONPATH`` at another checkout it times that checkout's kernels.
"""

from __future__ import annotations

import statistics
import sys

import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import ct_plan, gcc_phat
from radio_mapper_tpu_torch.ops.cuda import build, channel_step, detect_ct, fft_detect, fft_rows

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


def main() -> int:
    card = device.require_cuda()
    tag = card.label()
    print(card.smi)
    dev = torch.device("cuda", 0)
    build.library()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
