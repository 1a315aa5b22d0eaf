"""Readings for a cell's correctness limits, in one process on the card.

    python3 benchmark/tools/calibrate.py --workload <name> --seeds <a>:<b> \
        [--control-seeds <a>:<b>] [--program-tf32-seeds <a>:<b>]

For each seed: the cell's scene, ``check_dispatches`` dispatches of the
program at the cell's own size, and the check's
numbers against the plain reference (the lower readings). For each
control seed the same with the reference computed in TF32 put in the
program's place; for each ``--program-tf32-seeds`` seed the program with
its own TF32 path on (``torch.backends.cuda.matmul.allow_tf32``). One JSON
line a seed on standard output, and with ``--out`` also into that file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _seeds(text: str | None) -> list:
    if not text:
        return []
    a, b = (int(x) for x in text.split(":"))
    return list(range(a, b))


def readings(cell, seed: int, program, device, tf32: bool = False) -> dict:
    import torch

    from harness import check, scene
    from reference import tdoa

    step = tdoa.Step.from_config(cell.config["pipeline"])
    sc = scene.synthesize(cell.config["pipeline"], int(cell.config["channels"]), cell.traffic, seed, device)
    k = int(cell.traffic["check_dispatches"])
    outs = []
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for i in range(k):
            out = program.step_split_uint8(sc.pool[i % len(sc.pool)], sc.anchors)
            out.fix.position_enu.to("cpu")
            outs.append(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tie = cell.limits["limits"]["lag_pick"]
    res = [check.compare(sc.pool[i % len(sc.pool)], sc.anchors, o, step, tie) for i, o in enumerate(outs)]
    return check.merge(res)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default=None)
    ap.add_argument("--control-seeds", default=None)
    ap.add_argument("--program-tf32-seeds", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import driver, manifest
    from harness.control import ReferenceProgram
    from reference import tdoa

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    cell = manifest.load_cell(args.workload, ROOT)
    prog = driver.build_program(cell, dev)
    control = ReferenceProgram(tdoa.Step.from_config(cell.config["pipeline"]), tf32=True)
    sink = open(args.out, "a") if args.out else None
    runs = [("program", s, prog, False) for s in _seeds(args.seeds)]
    runs += [("control_reference_tf32", s, control, False) for s in _seeds(args.control_seeds)]
    runs += [("control_program_tf32", s, prog, True) for s in _seeds(args.program_tf32_seeds)]
    try:
        for kind, seed, program, tf32 in runs:
            t = time.perf_counter()
            nums = readings(cell, seed, program, dev, tf32)
            line = json.dumps({"workload": cell.name, "kind": kind, "seed": seed, "numbers": nums,
                               "seconds": round(time.perf_counter() - t, 2)})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
