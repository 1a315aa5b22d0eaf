"""Time kernels K2, K5 and K6 with parts of the GCC pair body taken out.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 -m radio_mapper_tpu_torch.tools.pair_parts

It copies ``csrc/gcc_pair.cu`` and the headers it includes into
``radio_mapper_tpu_torch/_build/pair_parts/<variant>/``, takes parts of
``rm_pair::pair_lag_window`` out of each copy by the text edits of
:data:`EDITS`, builds every copy with nvcc in parallel and times, through
the package's own wrappers, K5 at the wideband shape [16, 64, 5120] →
[16, 2016, 257], K2 at the flagship shape [128, 8, 17408] → [128, 28,
1025] (l2rx, and l2 with its first pass) and K6 at [2016, 5120] × 4: the
mean of 20 back-to-back launches between two CUDA events, median of 3, so
the host's time to call the wrapper overlaps the card's work. A variant
without a part computes wrong windows; its time says how much of the
kernel's time that part holds. The full body's windows are checked
against the plain version (1e-4 of the window max).
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys

import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import gcc_phat
from radio_mapper_tpu_torch.ops.cuda import build, gcc_pair

SOURCES = ("gcc_pair.cu", "gcc_pair.cuh", "ct_fft.cuh", "ct_dft.cuh")

# part → (file, text, replacement): the text occurs exactly once
EDITS = {
    "fft": ("gcc_pair.cuh", "      inverse_row_fft<N1>(v, rtw, lane);\n", ""),
    "fold": ("gcc_pair.cuh", "for (int rl = 0; rl < rows; ++rl) rm_ct::cmac(",
             "for (int rl = 0; rl < 0; ++rl) rm_ct::cmac("),
    # spectra values made from their addresses: no device-memory or L2 reads
    "loads": ("gcc_pair.cuh", "  if constexpr (FRESH) return __ldcg(p);\n  else return __ldg(p);",
              "  return static_cast<float>(reinterpret_cast<size_t>(p) & 1023);"),
    "whiten": ("gcc_pair.cuh", "        v[i] = whiten(rr, ri, gate, floor2, l1_floor);",
               "        v[i] = make_float2(rr, ri);"),
    # no store: nothing reads the row, so its loads and arithmetic go too
    "store": ("gcc_pair.cuh", "      if (live) {\n        twiddle_store", "      if (false) {\n        twiddle_store"),
}

VARIANTS = {
    "full body": (),
    "no FFT": ("fft",),
    "no fold": ("fold",),
    "rows: no FFT, no fold": ("fft", "fold"),
    "rows without loads": ("fft", "fold", "loads"),
    "rows without whitening": ("fft", "fold", "whiten"),
    "skeleton: no row work": ("fft", "fold", "store"),
}


def variant_sources(parts) -> dict:
    """The edited sources of a variant without ``parts``: name → text."""
    src = {f: (build.CSRC / f).read_text() for f in SOURCES}
    for part in parts:
        f, old, new = EDITS[part]
        if src[f].count(old) != 1:
            raise RuntimeError(f"edit {part!r} no longer matches {f}")
        src[f] = src[f].replace(old, new)
    return src


def _start_build(name: str, parts):
    d = build.BUILD_DIR / "pair_parts" / name.replace(" ", "_").replace(":", "").replace(",", "")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f, text in variant_sources(parts).items():
        (d / f).write_text(text)
    so = d / "libpair.so"
    cmd = [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-o", str(so), str(d / "gcc_pair.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    jobs = {name: _start_build(name, parts) for name, parts in VARIANTS.items()}
    libs = {}
    for name, (so, proc) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{text}")
        regs = sorted({ln.split(":", 1)[1].strip() for ln in text.splitlines() if "Used" in ln})
        print(f"{name}: ptxas {'; '.join(regs)}")
        libs[name] = ctypes.CDLL(str(so))

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g)
    w_re, w_im = rnd(16, 64, 5120), rnd(16, 64, 5120)  # K5: 16 subchannels × 64 receivers
    wpi, wpj = gcc_phat.pair_indices(64)
    s2 = rnd(16, len(wpi)).abs() + 1.0
    f_re, f_im = rnd(128, 8, 17408), rnd(128, 8, 17408)  # K2: 128 channels × 8 receivers
    smax = rnd(128, 8).abs() + 1.0
    pi, pj = gcc_phat.pair_indices(8)
    rows = [rnd(len(wpi), 5120) for _ in range(4)]  # K6: one subchannel's pairs, gathered
    s6 = rnd(len(wpi)).abs() + 1.0
    k5 = lambda: gcc_pair.gcc_pairs_onehot_lag_mags(w_re, w_im, wpi, wpj, max_lag=128, s2=s2)
    k2 = lambda: gcc_pair.gcc_pair_lag_mags(f_re, f_im, smax, pi, pj, max_lag=512)
    k6 = lambda: gcc_pair.gcc_rows_lag_mags(*rows, max_lag=128, s2=s6)
    ref = gcc_pair.gcc_pairs_onehot_lag_mags_plain(w_re, w_im, wpi, wpj, max_lag=128, s2=s2)

    saved = build._lib
    try:
        for name, lib in libs.items():
            build._lib = lib  # the wrappers look their entries up here
            if not VARIANTS[name]:
                rel = ((k5() - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
                if rel > 1e-4:
                    raise AssertionError(f"the full body's K5 windows disagree with the plain version: {rel}")
            t5, t2, t6 = _mean_ms(k5), _mean_ms(k2), _mean_ms(k6)
            gcc_pair.set_phat_gate("l2")
            try:
                t2l2 = _mean_ms(k2)
            finally:
                gcc_pair.set_phat_gate("l2rx")
            print(f"{name:24s} K5 {t5:.3f} ms, K2 {t2:.3f} ms (l2 {t2l2:.3f}), K6 {t6:.3f} ms {tag}")
    finally:
        build._lib = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
