"""Time the long-row FFT kernels, K3 above 24576 and K7 at 32768/65536,
and split each wrapper call into its device kernels.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 -m radio_mapper_tpu_torch.tools.kernel_split

For K3 (``fft_rows.fft_rows_ct``) at [1024, 33792], [1024, 58368] and
[1024, 66560], and for K7 (``fft_natural.fft_rows``) at [8192, 32768] and
[4096, 65536], on seeded rows, it prints:

- the wrapper's time back to back: the mean of 20 launches between two
  CUDA events, median of 3;
- each device kernel the call launches, by name, with its launches per
  call and its mean device time per call, from ``torch.profiler`` over 10
  calls (a design of two launches shows both, each on its own);
- for K7 the design that ran, ``torch.fft.fft`` on the same rows back to
  back, and the bytes bound: 16 B a point (a row read once, its spectrum
  written once) over the H100 SXM's 3.35 TB/s.

Run by its path (``python3 radio_mapper_tpu_torch/tools/kernel_split.py``)
with ``PYTHONPATH`` at another checkout, it times that checkout's kernels:
it calls only the wrappers' public functions.
"""

from __future__ import annotations

import statistics
import sys

import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops.cuda import build, fft_natural, fft_rows

HBM_BYTES = 3.35e12  # bytes/s, H100 SXM


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


def _short(name: str) -> str:
    """A demangled kernel name without its namespace, return type and
    parameters (template arguments kept)."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.split(" ")[-1] if "<" not in name else name[name.rfind(" ", 0, name.index("<")) + 1:]


def device_kernels(fn, calls=10):
    """``{kernel: (launches a call, device ms a call)}`` of ``fn()`` from
    torch.profiler's kernel events; empty if the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = _short(e.name)
        n, us = out.get(k, (0, 0.0))
        out[k] = (n + 1, us + e.time_range.elapsed_us())
    return {k: (n / calls, us / calls / 1e3) for k, (n, us) in out.items()}


def _kernels_text(kernels) -> str:
    if not kernels:
        return "profiler: no device events"
    return "; ".join(f"{k} x{n:g} {ms:.4f} ms" for k, (n, ms) in kernels.items())


def main() -> int:
    card = device.require_cuda()
    tag = card.label()
    print(card.smi)
    dev = torch.device("cuda", 0)
    build.library()
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, n in ((1024, 33_792), (1024, 58_368), (1024, 66_560)):
        xr = 40.0 * torch.randn(rows, n, device=dev, generator=g)
        xi = 40.0 * torch.randn(rows, n, device=dev, generator=g)
        call = lambda: fft_rows.fft_rows_ct(xr, xi)
        ms = _mean_ms(call)
        print(f"K3 [{rows}, {n}]: {ms:.4f} ms back to back; {_kernels_text(device_kernels(call))} {tag}")
        del xr, xi
    for rows, n in ((8192, 32_768), (4096, 65_536)):
        xr = torch.randn(rows, n, device=dev, generator=g)
        xi = torch.randn(rows, n, device=dev, generator=g)
        call = lambda: fft_natural.fft_rows(xr, xi)
        ms = _mean_ms(call)
        kernels = device_kernels(call)
        xc = torch.complex(xr, xi)
        del xr, xi
        lib_ms = _mean_ms(lambda: torch.fft.fft(xc))
        del xc
        bound_ms = 1e3 * 16 * rows * n / HBM_BYTES
        print(f"K7 [{rows}, {n}], design {fft_natural.design(n)}: {ms:.4f} ms back to back "
              f"({16 * rows * n / ms / 1e9:.3f} TB/s), torch.fft.fft {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"(bytes); {_kernels_text(kernels)} {tag}")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
