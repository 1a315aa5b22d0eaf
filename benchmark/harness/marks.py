"""Spans at the program's own stage marks (its ``on_stage`` hook).

Each mark records a CUDA event (device time between marks) and a
zero-length ``record_function`` range ``bench.mark.<stage>`` that names
the host's activity in a profiler trace. A stage marked more than once
in a dispatch (the pair stage's chunks) sums its spans.
"""

from __future__ import annotations

import torch


class Marks:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.events: list = []  # (name, event or None)

    def start(self) -> None:
        self.events = []
        self("start")

    def __call__(self, name: str) -> None:
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        with torch.profiler.record_function(f"bench.mark.{name}"):
            pass
        self.events.append((name, ev))

    def spans(self) -> dict:
        """Device ms by stage for the dispatch just done (after its
        read-back, so every event has completed); empty off the card."""
        dev = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            if a is not None:
                dev[name] = dev.get(name, 0.0) + a.elapsed_time(b)
        return dev
