"""Detection/fix persistence: JSONL append log with rotation and reload.

A copy of ``radio_mapper_tpu/utils/storage.py`` on the port's datamodel
(importing the reference's module would load JAX through its package
``__init__``); a test holds the files the two write against each other.
Detections and triangulated fixes append to daily-rotated JSONL files, and
the central service reloads the recent window on startup, so a restart
resumes with its correlation buffer warm.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from datetime import datetime, timezone
from typing import Iterator, List, Optional, Type, TypeVar

from radio_mapper_tpu_torch.runtime.datamodel import (
    LiveSignalDetection,
    NumpyJSONEncoder,
    TriangulatedSignal,
    parse_iso,
)

T = TypeVar("T")


class SignalStore:
    def __init__(
        self,
        data_directory: str = "./data",
        *,
        max_age_hours: float = 24.0,
        flush_every: int = 1,
    ):
        self.dir = data_directory
        self.max_age_s = max_age_hours * 3600.0
        self.flush_every = flush_every
        os.makedirs(self.dir, exist_ok=True)
        self._files = {}
        self._pending = 0

    def _path(self, kind: str) -> str:
        day = datetime.now(timezone.utc).strftime("%Y%m%d")
        return os.path.join(self.dir, f"{kind}-{day}.jsonl")

    def _file(self, kind: str):
        path = self._path(kind)
        f = self._files.get(kind)
        if f is None or f.name != path:  # daily rotation
            if f is not None:
                f.close()
            f = open(path, "a")
            self._files[kind] = f
        return f

    def append(self, kind: str, record) -> None:
        if dataclasses.is_dataclass(record) and not isinstance(record, type):
            record = dataclasses.asdict(record)
        f = self._file(kind)
        f.write(json.dumps(record, cls=NumpyJSONEncoder) + "\n")
        self._pending += 1
        if self._pending >= self.flush_every:
            f.flush()
            self._pending = 0

    def append_detection(self, det: LiveSignalDetection) -> None:
        # IQ snippets are large and reproducible from captures; don't log them.
        record = dataclasses.asdict(det)
        record.pop("iq_samples", None)
        self.append("detections", record)

    def append_fix(self, sig: TriangulatedSignal) -> None:
        self.append("fixes", sig)

    def _iter_records(self, kind: str) -> Iterator[dict]:
        for path in sorted(glob.glob(os.path.join(self.dir, f"{kind}-*.jsonl"))):
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            yield json.loads(line)
                        except json.JSONDecodeError:
                            continue
            except OSError:
                continue

    def _load(self, kind: str, cls: Type[T], window_s: Optional[float]) -> List[T]:
        window_s = self.max_age_s if window_s is None else window_s
        cutoff = time.time() - window_s
        out: List[T] = []
        field_names = {f.name for f in dataclasses.fields(cls)}
        for rec in self._iter_records(kind):
            ts = rec.get("timestamp_utc") or (rec.get("detection_timestamps") or [None])[0]
            try:
                if ts is not None and parse_iso(ts).timestamp() < cutoff:
                    continue
            except (ValueError, TypeError):
                continue
            try:
                out.append(cls(**{k: v for k, v in rec.items() if k in field_names}))
            except TypeError:
                continue
        return out

    def load_detections(self, window_s: Optional[float] = None) -> List[LiveSignalDetection]:
        return self._load("detections", LiveSignalDetection, window_s)

    def load_fixes(self, window_s: Optional[float] = None) -> List[TriangulatedSignal]:
        return self._load("fixes", TriangulatedSignal, window_s)

    def cleanup(self) -> int:
        """Delete whole files older than the retention window. Returns count."""
        removed = 0
        cutoff = time.time() - self.max_age_s - 86_400  # keep current+previous day
        for path in glob.glob(os.path.join(self.dir, "*.jsonl")):
            try:
                if os.path.getmtime(path) < cutoff:
                    os.remove(path)
                    removed += 1
            except OSError:
                continue
        return removed

    def close(self):
        for f in self._files.values():
            try:
                f.flush()
                f.close()
            except OSError:
                pass
        self._files.clear()
