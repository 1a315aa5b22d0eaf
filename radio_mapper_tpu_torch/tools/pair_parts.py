"""Time kernels K2, K5 and K6 with parts of the GCC pair body taken out.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 -m radio_mapper_tpu_torch.tools.pair_parts

It copies ``csrc/gcc_pair.cu`` and the headers it includes into
``radio_mapper_tpu_torch/_build/pair_parts/<variant>/``, takes parts of
the pair body (``rm_wide::wide_pair_body``, every n1) out of each copy by
the text edits of :data:`EDITS` ("loads" are its bulk copies), builds
every copy with nvcc in parallel and times, through
the package's own wrappers, K5 at the wideband shape [16, 64, 5120] →
[16, 2016, 257], K2 at the flagship shape [128, 8, 17408] → [128, 28,
1025] (l2rx, and l2 with its first pass) and K6 at [2016, 5120] × 4, then
the wide inner lengths: K2 at [128, 8, 58368] (n1 = 384, the flagship at
block_len 57344, max_lag 600) and [8, 8, 121856] (n1 = 896), K5 at
[1, 64, 58368]: the mean of 20 back-to-back launches between two CUDA
events, median of 3, so the host's time to call the wrapper overlaps the
card's work. Each build's ``-Xptxas -v`` report gives every kernel's
registers and spilled bytes. A variant without a part computes wrong
windows; its time says how much of the kernel's time that part holds.
The full body's windows are checked against the plain version (1e-4 of
the window max, same argmax).
"""

from __future__ import annotations

import ctypes
import functools
import shutil
import statistics
import subprocess
import sys

import torch

from radio_mapper_tpu_torch import device
from radio_mapper_tpu_torch.ops import gcc_phat
from radio_mapper_tpu_torch.ops.cuda import build, gcc_pair

SOURCES = ("gcc_pair.cu", "gcc_pair.cuh", "gcc_pair_wide.cuh", "ct_fft.cuh", "ct_dft.cuh")
BODY = "gcc_pair_wide.cuh"

# part → [(file, text, replacement)]: each text occurs exactly once
EDITS = {
    "fft": [(BODY, "        inverse_row_fft_wide<N1>(v, twt, lane);\n", "")],
    "fold": [(BODY, "    if (wntl > 0) fold_any<P, MT, SW>(", "    if (false) fold_any<P, MT, SW>(")],
    # no bulk copies: no device-memory or L2 reads of the spectra
    "loads": [(BODY, "  const int ncopy = t.nsrc * 2;", "  const int ncopy = 0;")],
    "whiten": [(BODY, "          v[i] = rm_pair::whiten(rr_, ri_, gate, floor2, l1_floor);",
                "          v[i] = make_float2(rr_, ri_);")],
    # no store: nothing reads the row, so its loads and arithmetic go too
    "store": [(BODY, "    cre[o] = c.x;\n    cim[o] = c.y;\n", "")],
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
        for f, old, new in EDITS[part]:
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


def _shapes(dev):
    """The timed calls: name → (kernel call, plain call or None)."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g)
    out = {}
    w_re, w_im = rnd(16, 64, 5120), rnd(16, 64, 5120)  # K5: 16 subchannels × 64 receivers
    wpi, wpj = gcc_phat.pair_indices(64)
    s2 = rnd(16, len(wpi)).abs() + 1.0
    out["K5"] = (lambda: gcc_pair.gcc_pairs_onehot_lag_mags(w_re, w_im, wpi, wpj, max_lag=128, s2=s2),
                 lambda: gcc_pair.gcc_pairs_onehot_lag_mags_plain(w_re, w_im, wpi, wpj, max_lag=128, s2=s2))
    pi, pj = gcc_phat.pair_indices(8)
    for c, n, lag in ((128, 17408, 512), (128, 58368, 600), (8, 121856, 600)):  # K2: c channels × 8 receivers
        f_re, f_im, smax = rnd(c, 8, n), rnd(c, 8, n), rnd(c, 8).abs() + 1.0
        name = f"K2 [{c}, 8, {n}]"
        out[name] = (functools.partial(gcc_pair.gcc_pair_lag_mags, f_re, f_im, smax, pi, pj, max_lag=lag),
                     functools.partial(gcc_pair.gcc_pair_lag_mags_plain, f_re, f_im, smax, pi, pj, max_lag=lag))
    rows = [rnd(len(wpi), 5120) for _ in range(4)]  # K6: one subchannel's pairs, gathered
    s6 = rnd(len(wpi)).abs() + 1.0
    out["K6"] = (lambda: gcc_pair.gcc_rows_lag_mags(*rows, max_lag=128, s2=s6), None)
    m_re, m_im = rnd(1, 64, 58368), rnd(1, 64, 58368)  # K5 at n1 = 384
    ms2 = rnd(1, len(wpi)).abs() + 1.0
    out["K5 [1, 64, 58368]"] = (
        lambda: gcc_pair.gcc_pairs_onehot_lag_mags(m_re, m_im, wpi, wpj, max_lag=600, s2=ms2),
        lambda: gcc_pair.gcc_pairs_onehot_lag_mags_plain(m_re, m_im, wpi, wpj, max_lag=600, s2=ms2))
    return out


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
        report = build.ptxas_report(text)
        print(f"{name}: ptxas " + "; ".join(
            f"{r['kernel']} {r['registers']} registers, spills {r['spill_stores']}/{r['spill_loads']} B"
            for r in report))
        libs[name] = ctypes.CDLL(str(so))

    calls = _shapes(dev)
    refs = {k: plain() for k, (_, plain) in calls.items() if plain is not None}
    torch.cuda.synchronize()
    saved = build._lib
    try:
        for name, lib in libs.items():
            build._lib = lib  # the wrappers look their entries up here
            if not VARIANTS[name]:
                for k, ref in refs.items():
                    got = calls[k][0]()
                    rel = ((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
                    if rel > 1e-4 or not bool((got.argmax(-1) == ref.argmax(-1)).all()):
                        raise AssertionError(f"the full body's {k} windows disagree with the plain version: {rel}")
            times = {k: _mean_ms(run) for k, (run, _) in calls.items()}
            gcc_pair.set_phat_gate("l2")
            try:
                times["K2 [128, 8, 17408] l2"] = _mean_ms(calls["K2 [128, 8, 17408]"][0])
            finally:
                gcc_pair.set_phat_gate("l2rx")
            print(f"{name:24s} " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()) + f" {tag}")
    finally:
        build._lib = saved
    return 0


if __name__ == "__main__":
    sys.exit(main())
