"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root, on a machine with the cards the cell asks for.
The last line of standard output is the run's result (JSON); the last
lines of standard error are the check's numbers beside their limits.
Exits non-zero, with no result, without a card, with fewer cards than
the cell needs, without the program, or if a module of the JAX package
was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import driver, manifest

    try:
        cell = manifest.load_cell(args.workload, ROOT)
        result, rows = driver.run(cell, args.seed, args.seconds, bool(args.trace), t0=T0)
        driver.emit(result, rows)
    except driver.RunError as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
