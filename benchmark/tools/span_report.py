"""The program's own spans of one traced run, span by span.

    python3 benchmark/tools/span_report.py --workload <name> --seed <n> --seconds <s> [--out <file>]

Runs the cell once as ``--trace 1`` runs it (``harness.driver.run``), in this process on the
card, then reads the window's step records
(``radio_mapper_tpu_torch.utils.spans``): for each span name the medians
over the window's dispatches of its host ms, self host ms, device ms and
synchronising calls (its own, and inside it). Prints one JSON object
(with ``--out``, also into that file), whose ``result`` is the run's
result line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _median(vals):
    vals = [v for v in vals if v is not None]
    return statistics.median(vals) if vals else None


def report(cell, seed: int, seconds: float, **run_kw) -> dict:
    """Run ``cell`` traced once and read its spans (keywords go to
    :func:`harness.driver.run`)."""
    from harness import driver
    from radio_mapper_tpu_torch.utils import spans as program_spans

    before = program_spans.steps()
    last = before[-1].seq if before else -1
    result, _ = driver.run(cell, seed, seconds, True, t0=time.perf_counter(), **run_kw)
    # the run's steps: the warm dispatches, the window's, then the profiled ones
    recs = [r for r in program_spans.steps() if r.seq > last]
    recs = recs[driver.WARM_DISPATCHES:driver.WARM_DISPATCHES + result["window"]["dispatches"]]

    names = []
    for rec in recs:
        names += [s.name for s in rec.spans if s.name not in names]
    spans = {}
    for name in names:
        own = [sum(s.syncs for s in rec.spans if s.name == name) for rec in recs]
        spans[name] = {
            "count_a_step": _median([sum(s.name == name for s in rec.spans) for rec in recs]),
            "host_ms": _median([rec.host_ms(name) for rec in recs]),
            "self_host_ms": _median([rec.self_host_ms(name) for rec in recs]),
            "device_ms": _median([rec.device_ms(name) for rec in recs]),
            "syncs_own": _median(own),
            "syncs_own_max": max(own) if own else None,
            "syncs_inside": _median([rec.syncs(name) for rec in recs]),
        }
    return {"workload": cell.name, "seed": seed, "steps": len(recs), "spans": spans, "result": result}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from harness import driver, manifest

    try:
        out = report(manifest.load_cell(args.workload, ROOT), args.seed, args.seconds)
    except driver.RunError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
