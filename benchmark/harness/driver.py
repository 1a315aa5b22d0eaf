"""One run of one cell: set-up, a timed closed loop, the trace, the check.

The entry the window drives is the program's ``step_split_uint8``: raw
interleaved uint8 IQ of a dispatch, already on the card, decoded there.
A dispatch ends when its fixes are on the host; the next one starts
then (a closed loop with one caller). The window cycles through the
scene's pool of distinct dispatches for ``--seconds`` and ends with the
last dispatch started in it.

End-to-end metrics (``--trace 0``, host clock): ``iq_msps``, every IQ
sample of every dispatch completed in the window over the window's
seconds; ``dispatch_p95_ms``, the 95th percentile of the dispatches'
latencies; ``setup_s``, from the process's start to the window's.
``--trace 1`` runs the same window with the program's stage marks
recorded, then traces a few more dispatches with ``torch.profiler``,
and reports the per-layer metrics instead.

After the window the program is dropped and the check compares a
sample of the window's dispatches, drawn from the seed, with the plain
reference (:mod:`harness.check`).
"""

from __future__ import annotations

import gc
import json
import random
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from harness import check, guard, manifest, peaks, scene, trace
from harness.marks import Marks
from reference import tdoa

THREADS = 2
WARM_DISPATCHES = 2
PROFILE_DISPATCHES = 3
PROFILE_SECONDS = 1.0


class RunError(RuntimeError):
    """A run that must end without a result line."""


@dataclass
class RunData:
    """What the per-layer readers read."""

    cell: manifest.Cell
    lead: tuple
    blocks: int  # blocks a dispatch: D, or 1 without a leading dispatch axis
    device_spans: list = field(default_factory=list)  # per dispatch {stage: ms}
    trace: trace.TraceSummary | None = None
    profiled_dispatches: int = 0  # dispatches inside the traced window
    window_s: float = 0.0  # the measured window's seconds and dispatches
    dispatches: int = 0
    memory_peak_bytes: int = 0


def _card() -> dict:
    """The card's name and power limit (``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in out.split(","))
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": torch.cuda.get_device_name(0), "power_limit": "not read"}


def build_program(cell: manifest.Cell, device: torch.device):
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline

    return TDOAPipeline(PipelineConfig(**cell.config["pipeline"]), device=device)


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, *, t0: float,
        device: str = "cuda", program=None, require_chip: bool = True, log=None) -> tuple[dict, list]:
    """``(result line, check rows)`` of one run."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    dev = torch.device(device)
    if require_chip:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"the cell needs {cell.chips} cards, {torch.cuda.device_count()} present")
        dev = torch.device("cuda", 0)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(THREADS)
    pipeline = cell.config["pipeline"]
    step = tdoa.Step.from_config(pipeline)
    prog = program if program is not None else build_program(cell, dev)
    sc = scene.synthesize(pipeline, int(cell.config["channels"]), cell.traffic, seed, dev)
    anchors = sc.anchors
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    marks = Marks(dev)

    def dispatch(i: int, marked: bool):
        x = sc.pool[i % len(sc.pool)]
        if marked:
            marks.start()
        with torch.profiler.record_function("bench.dispatch"):
            out = prog.step_split_uint8(x, anchors, on_stage=marks if marked else None)
        with torch.profiler.record_function("bench.readback"):
            out.fix.position_enu.to("cpu")  # the dispatch ends when its fixes are on the host
        return out

    for i in range(WARM_DISPATCHES):
        dispatch(i, traced)
    sync()
    setup_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    data = RunData(cell, sc.lead, sc.lead[0] if len(sc.lead) == 2 else 1)
    k_check = int(cell.traffic["check_dispatches"])
    rng = random.Random(int(seed) * 1_000_003 + 17)
    sample: list = []  # reservoir of (dispatch index, output), uniform over the window's dispatches
    latencies = []
    gc.collect()
    gc.disable()  # no collector pauses inside the window
    w0 = time.perf_counter()
    n = 0
    while True:
        t_a = time.perf_counter()
        if t_a - w0 >= seconds and n > 0:
            break
        out = dispatch(n, traced)
        latencies.append(time.perf_counter() - t_a)
        if traced:
            data.device_spans.append(marks.spans())
        n += 1
        if len(sample) < k_check:
            sample.append((n - 1, out))
        else:
            j = rng.randrange(n)
            if j < k_check:
                sample[j] = (n - 1, out)
        del out
    w1 = time.perf_counter()
    gc.enable()
    window_s = w1 - w0
    data.window_s, data.dispatches = window_s, n
    data.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    if traced and cuda:
        profiled_ms = []

        def more(min_n: int, min_s: float) -> None:
            t_p = time.perf_counter()
            while len(profiled_ms) < min_n or time.perf_counter() - t_p < min_s:
                t_d = time.perf_counter()
                dispatch(n + len(profiled_ms), True)
                profiled_ms.append(1e3 * (time.perf_counter() - t_d))
        data.trace = trace.profile(more, PROFILE_DISPATCHES, PROFILE_SECONDS)
        data.profiled_dispatches = len(profiled_ms)

    del prog, program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_c = time.perf_counter()
    limits = cell.limits["limits"]
    results = []
    for idx, out in sorted(sample, key=lambda s: s[0]):
        results.append(check.compare(sc.pool[idx % len(sc.pool)], anchors, out, step, limits["lag_pick"]))
    failed = sum(not check.verdict(r, limits)[0] for r in results)
    correct, rows = check.verdict(check.merge(results), limits)
    log(f"check: {len(sample)} dispatches ({sorted(s[0] for s in sample)}) compared in "
        f"{time.perf_counter() - t_c:.1f} s")

    samples = n * sc.samples_per_dispatch
    lat_ms = [1e3 * x for x in latencies]
    p95 = statistics.quantiles(lat_ms, n=20)[18] if len(lat_ms) >= 2 else lat_ms[0]
    if traced:
        metrics = per_layer(cell, data)
    else:
        e2e = {
            "iq_msps": (samples / window_s / 1e6, "MS/s"),
            "dispatch_p95_ms": (p95, "ms"),
            "setup_s": (setup_s, "s"),
        }
        metrics = {m["name"]: {"value": e2e[m["name"]][0], "unit": m["unit"]} for m in cell.end_to_end}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": data.memory_peak_bytes,
    }
    result = {
        "correct": bool(correct),
        "attempted": n,
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if traced and data.trace is not None:
        device_info["busy_s"] = data.trace.busy_s
        device_info["window_s"] = data.trace.window_s
        result["breakdown"] = {"device_ops": data.trace.device_ops, "idle_gaps": data.trace.idle_gaps}
    if cuda and traced:
        result["card"] = _card()
    result["window"] = {
        "dispatches": n, "seconds": window_s, "setup_s": setup_s,
        "latency_ms_median": statistics.median(lat_ms), "latency_ms_p95": p95,
        "latency_ms_max": max(lat_ms),
        "iq_samples": samples,
    }
    if traced and data.trace is not None:
        result["window"]["profiled_latency_ms_median"] = statistics.median(profiled_ms)
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows


def per_layer(cell: manifest.Cell, data: RunData) -> dict:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in cell.per_layer:
        spec = manifest.metric_spec(m["name"], cell.bench_dir)
        value = manifest.reader(spec["reader"], cell.bench_dir).read(data, **spec.get("args", {}))
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def emit(result: dict, rows: list) -> None:
    """The check's numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    bad = guard.forbidden_modules()
    if bad:
        raise RunError(f"modules of the JAX package are loaded: {bad}")
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def least_ms(cell: manifest.Cell, data: RunData, work: str) -> float:
    """The least time of a stage's work for one dispatch (ms)."""
    mod = manifest.work(work, cell.bench_dir)
    flops, nbytes = mod.least(cell.config["pipeline"], data.lead)
    return 1e3 * peaks.least_seconds(flops, nbytes)


def median_stage_ms(spans: list, stages: list) -> float | None:
    vals = [sum(s[k] for k in stages) for s in spans if all(k in s for k in stages)]
    return statistics.median(vals) if vals else None

