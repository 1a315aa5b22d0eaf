"""Lightweight metrics registry: counters, gauges, timers.

A copy of ``radio_mapper_tpu/utils/metrics.py`` (importing the reference's
module would load JAX through its package ``__init__``); a test holds the
two against each other on the same calls. It backs the central service's
``/metrics`` endpoint: thread-safe counters and gauges plus EWMA-and-
quantile timers, rendered as JSON and as Prometheus text exposition.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


class Timer:
    """Duration tracker with count/mean/EWMA and a sliding p50/p95/max."""

    def __init__(self, window: int = 256, ewma_alpha: float = 0.1):
        self.count = 0
        self.total_s = 0.0
        self.ewma_s: Optional[float] = None
        self._alpha = ewma_alpha
        self._recent = deque(maxlen=window)
        self._lock = threading.Lock()

    def observe(self, seconds: float):
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.ewma_s = (
                seconds
                if self.ewma_s is None
                else self._alpha * seconds + (1 - self._alpha) * self.ewma_s
            )
            self._recent.append(seconds)

    def time(self):
        return _TimerContext(self)

    def snapshot(self) -> Dict:
        with self._lock:
            recent = sorted(self._recent)
            q = lambda p: recent[min(len(recent) - 1, int(p * len(recent)))] if recent else 0.0
            return {
                "count": self.count,
                "mean_s": self.total_s / self.count if self.count else 0.0,
                "ewma_s": self.ewma_s or 0.0,
                "p50_s": q(0.50),
                "p95_s": q(0.95),
                "max_s": max(recent) if recent else 0.0,
            }


class _TimerContext:
    def __init__(self, timer: Timer):
        self.timer = timer

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timer.observe(time.perf_counter() - self.t0)


class MetricsRegistry:
    def __init__(self):
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._timers: Dict[str, Timer] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, value: float = 1.0):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    def timer(self, name: str) -> Timer:
        with self._lock:
            if name not in self._timers:
                self._timers[name] = Timer()
            return self._timers[name]

    def snapshot(self) -> Dict:
        with self._lock:
            out = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "timers": {k: t.snapshot() for k, t in self._timers.items()},
            }
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (counters/gauges/timer summaries)."""
        snap = self.snapshot()
        lines = []
        norm = lambda n: n.replace(".", "_").replace("-", "_")
        for k, v in sorted(snap["counters"].items()):
            lines.append(f"# TYPE {norm(k)} counter")
            lines.append(f"{norm(k)} {v}")
        for k, v in sorted(snap["gauges"].items()):
            lines.append(f"# TYPE {norm(k)} gauge")
            lines.append(f"{norm(k)} {v}")
        for k, t in sorted(snap["timers"].items()):
            base = norm(k)
            lines.append(f"# TYPE {base}_seconds summary")
            lines.append(f'{base}_seconds{{quantile="0.5"}} {t["p50_s"]}')
            lines.append(f'{base}_seconds{{quantile="0.95"}} {t["p95_s"]}')
            lines.append(f"{base}_seconds_count {t['count']}")
            lines.append(f"{base}_seconds_sum {t['mean_s'] * t['count']}")
        return "\n".join(lines) + "\n"


# Default process-wide registry.
registry = MetricsRegistry()
