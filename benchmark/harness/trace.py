"""The device trace of a short steady window: busy time, idle gaps named
by what the host was doing, and the device operations that took longest.

``torch.profiler`` (CUPTI) records the window; its Chrome trace is read
back as JSON. Device activity is every ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` event; busy time is the union of their intervals inside
the window (the harness's ``bench.profile_window`` range). A gap in
that union is named by the host's activity when it opened: the read-back
(``readback``), the stage the host was enqueueing (``enqueue.<stage>``,
the next ``bench.mark.<stage>`` of that dispatch), or ``host`` between
dispatches.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
TOP = 10


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: list = field(default_factory=list)  # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)  # [[name, seconds]]


def profile(run_dispatches, min_dispatches: int, min_seconds: float) -> TraceSummary:
    """Trace ``run_dispatches(min_dispatches, min_seconds)``, which runs at
    least that many dispatches for at least that long, and summarise."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.profile_window"):
            run_dispatches(min_dispatches, min_seconds)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarise(events)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarise(events: list) -> TraceSummary:
    """Busy and window seconds, device operations and idle gaps from a
    Chrome trace's ``traceEvents``."""
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    window = [e for e in host if e.get("name") == "bench.profile_window"]
    if not window:
        raise ValueError("the trace holds no bench.profile_window range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    spans = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)) for e in dev]
    merged = _union([(a, b) for a, b in spans if b > a])
    busy_us = sum(b - a for a, b in merged)
    by_name = defaultdict(float)
    for e in dev:
        by_name[str(e.get("name", "?"))[:120]] += float(e["dur"]) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    marks = sorted(
        (float(e["ts"]), e["name"][len("bench.mark."):])
        for e in host if str(e.get("name", "")).startswith("bench.mark.")
    )
    ranges = [
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in host if e.get("name") in ("bench.dispatch", "bench.readback")
    ]

    def host_doing(t: float) -> str:
        for a, b, name in ranges:
            if a <= t < b:
                if name == "bench.readback":
                    return "readback"
                nxt = [s for ts, s in marks if ts >= t and ts < b]
                return f"enqueue.{nxt[0]}" if nxt else "enqueue"
        return "host"

    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a), key=lambda ab: ab[0] - ab[1])
    return TraceSummary(
        busy_s=busy_us * 1e-6, window_s=(w1 - w0) * 1e-6,
        device_ops=[[k, v] for k, v in ops],
        idle_gaps=[[host_doing(a), (b - a) * 1e-6] for a, b in gaps[:TOP]],
    )
