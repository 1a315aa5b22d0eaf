"""Program spans of the step: the host and device time of the solver's
set-up and LM loop, and the host's synchronising calls.

Recording is on for a step exactly when its caller passes an ``on_stage``
hook to an entry of the step (a method wrapped by :func:`entry`:
``TDOAPipeline.step_split_uint8``, ``step_uint8``, ``step_split``,
``step``); there is no other switch. The outermost entry opens a step
record; an entry called from inside it joins that record. The caller's
hook is passed on untouched.

A span records its name, its parent, the step's sequence number (shared
by every span of one step) and its host start and end
(``time.perf_counter_ns``); on a CUDA device also a CUDA event at each
end. It enters ``torch.profiler.record_function("rm.<name>")``, so that
it lies in a profiler trace on the kernels' clock. The root span is
``step``; named spans (:func:`span`) nest under the innermost open span.

While a traced step runs, the host's synchronising calls are counted and
charged to the innermost open span: on a CUDA device the step runs under
``torch.cuda.set_sync_debug_mode("warn")``, and a warnings hook counts
c10's "called a synchronizing CUDA operation" warnings instead of
showing them (others pass on). Both are restored when the step ends.
The warnings hook is process-wide, as the warnings module is: a warning
another thread raises during a traced step passes through it too.

Finished steps are kept in a bounded process-wide store, the newest
``STORE_STEPS`` (:func:`steps`); a step that raised is not kept. A
step's device times are read from its events when first asked for.

With no hook, :func:`span` reads one context variable and returns a
shared no-op: no clock is read, no event made, no profiler range
entered, and the sync mode is not touched.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Optional

import torch

STORE_STEPS = 4096
RANGE_PREFIX = "rm."
SYNC_WARNING = "synchronizing CUDA operation"

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("radio_mapper_step_spans", default=None)
_NULL = contextlib.nullcontext()
_SEQ = itertools.count()
_LOCK = threading.Lock()
_STORE: deque = deque(maxlen=STORE_STEPS)


@dataclass
class Span:
    name: str
    parent: int  # index of the parent span in its step; -1 for the root
    seq: int  # the step's sequence number
    t0_ns: int
    t1_ns: int = 0
    syncs: int = 0  # synchronising calls while this was the innermost open span
    ev0: Optional[torch.cuda.Event] = None
    ev1: Optional[torch.cuda.Event] = None
    device_ms: Optional[float] = None  # from the events, once read

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6


@dataclass
class StepRecord:
    """One finished step: its spans in the order they opened (the root
    ``step`` first)."""

    seq: int
    spans: list

    def _indices(self, name: str) -> list:
        return [i for i, s in enumerate(self.spans) if s.name == name]

    def _within(self, i: int) -> list:
        """``i`` and every span below it."""
        out = [i]
        for j in range(i + 1, len(self.spans)):
            if self.spans[j].parent in out:
                out.append(j)
        return out

    def host_ms(self, name: str) -> Optional[float]:
        """Host ms of the spans named ``name``, summed; None if none."""
        idx = self._indices(name)
        return sum(self.spans[i].host_ms for i in idx) if idx else None

    def self_host_ms(self, name: str) -> Optional[float]:
        """:meth:`host_ms` less the host ms of the spans' children."""
        idx = self._indices(name)
        if not idx:
            return None
        return sum(
            self.spans[i].host_ms - sum(s.host_ms for s in self.spans if s.parent == i) for i in idx
        )

    def device_ms(self, name: str) -> Optional[float]:
        """Device ms (CUDA events) of the spans named ``name``, summed;
        None if none or off the card. Waits for the step's last event."""
        idx = self._indices(name)
        root = self.spans[0]
        if not idx or (root.device_ms is None and root.ev1 is None):
            return None
        if root.device_ms is None:
            root.ev1.synchronize()  # the root's end is recorded last
            for s in self.spans:
                s.device_ms = s.ev0.elapsed_time(s.ev1)
                s.ev0 = s.ev1 = None
        return sum(self.spans[i].device_ms for i in idx)

    def syncs(self, name: str) -> Optional[int]:
        """Synchronising calls inside the spans named ``name`` and the spans
        below them; None if none is named so."""
        idx = self._indices(name)
        if not idx:
            return None
        return sum(self.spans[j].syncs for i in idx for j in self._within(i))


def steps() -> list:
    """The stored steps, oldest first."""
    with _LOCK:
        return list(_STORE)


class _Step:
    """The recorder of one step, open while its outermost entry runs."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.rec = StepRecord(next(_SEQ), [])
        self.stack: list = []  # (span index, its profiler range) of the open spans, innermost last

    def _now(self):
        t = time.perf_counter_ns()
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        return t, ev

    def open(self, name: str) -> None:
        t, ev = self._now()
        parent = self.stack[-1][0] if self.stack else -1
        rf = torch.profiler.record_function(RANGE_PREFIX + name)
        rf.__enter__()
        self.stack.append((len(self.rec.spans), rf))
        self.rec.spans.append(Span(name, parent, self.rec.seq, t, ev0=ev))

    def close(self) -> None:
        i, rf = self.stack.pop()
        rf.__exit__(None, None, None)
        s = self.rec.spans[i]
        s.t1_ns, s.ev1 = self._now()

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message) and self.stack:
            self.rec.spans[self.stack[-1][0]].syncs += 1
        else:
            self._show(message, category, filename, lineno, file, line)

    def __enter__(self):
        self._token = _CURRENT.set(self)
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        self._show = warnings.showwarning
        warnings.showwarning = self._on_warning
        self._mode = None
        if self.cuda:
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        self.open("step")

    def __exit__(self, exc_type, exc, tb):
        try:
            self.close()
        finally:
            if self._mode is not None:
                torch.cuda.set_sync_debug_mode(self._mode)
            self._warnings.__exit__(None, None, None)
            _CURRENT.reset(self._token)
        if exc_type is None:
            with _LOCK:
                _STORE.append(self.rec)
        return False


class _SpanScope:
    __slots__ = ("step", "name")

    def __init__(self, step: _Step, name: str):
        self.step, self.name = step, name

    def __enter__(self):
        self.step.open(self.name)

    def __exit__(self, *exc):
        self.step.close()
        return False


def span(name: str):
    """A context manager recording span ``name`` in the open step; the
    shared no-op outside a traced step."""
    step = _CURRENT.get()
    return _NULL if step is None else _SpanScope(step, name)


def entry(method):
    """Make ``method`` (of an object with a ``device``, taking an
    ``on_stage`` keyword) an entry of the step: with a hook and no open
    step it runs inside a new step record; inside an open step, or with
    no hook, it runs as it is."""

    @functools.wraps(method)
    def wrapped(self, *args, on_stage=None, **kwargs):
        if on_stage is None or _CURRENT.get() is not None:
            return method(self, *args, on_stage=on_stage, **kwargs)
        with _Step(torch.device(self.device)):
            return method(self, *args, on_stage=on_stage, **kwargs)

    return wrapped
