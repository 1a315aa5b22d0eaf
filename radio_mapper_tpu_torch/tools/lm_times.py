"""Time the LM solve's kernel against the eager loop it replaces.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 -m radio_mapper_tpu_torch.tools.lm_times

It builds the package's kernels and times, on the set-up
:func:`..solver.lm_setup` makes for seeded problems, ``lm_solve.lm_solve``
(one launch) and ``solver.lm_loop`` (the plain version: some 60 launches
an iteration) at the flagship's shape (16,384 problems, 8 receivers, 28
pairs, 40 iterations, 2-D), narrowband's (4 starts × 2 × 128) and the
wideband's (16 problems of 64 receivers, 2016 pairs, 15 iterations): the
kernel as the mean of 20 back-to-back calls between two CUDA events, the
loop as the mean of 3, each the median of 3 such runs. Then each LM
kernel's registers, spills and stack from the build's ``-Xptxas -v``
report, and the card's name and power limit.
"""

from __future__ import annotations

import statistics
import subprocess

import torch

from radio_mapper_tpu_torch import solver, testing
from radio_mapper_tpu_torch.ops.cuda import build, lm_solve

# name → (lead shape, receivers, iterations, starts)
SHAPES = {
    "flagship": ((128, 128), 8, 40, 0),
    "narrowband": ((2, 128), 8, 40, 4),
    "wideband": ((16,), 64, 15, 0),
}


def _mean_ms(fn, reps):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    ev[1].synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def inputs(name, dev, seed=11):
    """The solver's set-up for ``name`` on ``dev``, with its iterations."""
    lead, b, iterations, starts = SHAPES[name]
    anchors, pi, pj, dd, w = testing.lm_problems(lead, b, seed)
    init = None
    if starts:
        init = solver.perturbed_starts(anchors, starts).reshape(starts, *(1,) * len(lead), 3)
        dd, w = dd.expand(starts, *dd.shape), w.expand(starts, *w.shape)
    on = lambda t: None if t is None else t.to(dev)
    args = solver.lm_setup(*(on(t) for t in (anchors, pi, pj, dd, w)), init_enu=on(init))
    return args, iterations


def main() -> int:
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card or torch.cuda.get_device_name(dev)}")
    for name in SHAPES:
        args, iterations = inputs(name, dev)
        kern = lambda: lm_solve.lm_solve(*args, iterations=iterations, solve_2d=True)
        loop = lambda: solver.lm_loop(*args, iterations=iterations, solve_2d=True)
        kern(), loop()
        torch.cuda.synchronize()
        k_ms = statistics.median(_mean_ms(kern, 20) for _ in range(3))
        l_ms = statistics.median(_mean_ms(loop, 3) for _ in range(3))
        n = args[3].numel() // args[3].shape[-1]
        kind = lm_solve.layout(args[3].shape[-1], args[0].shape[-2])
        print(f"{name}: N={n} P={args[3].shape[-1]} {kind} layout: kernel {k_ms:.4f} ms, loop {l_ms:.3f} ms "
              f"({l_ms / k_ms:.0f}x)")
    for k in build.ptxas_report(build.build_log()):
        if k["kernel"].startswith("lm_"):
            print(f"{k['kernel']}: {k['registers']} registers, spills {k['spill_stores']}/{k['spill_loads']} B, "
                  f"stack {k['stack']} B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
