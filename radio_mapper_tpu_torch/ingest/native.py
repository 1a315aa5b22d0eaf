"""ctypes binding of the host ingest ring (``native/ingest.cpp``).

Port of ``radio_mapper_tpu/ingest/native.py``: ``NativeIngest`` (file,
rtl_tcp, synthetic and paced synthetic sources; ``read_bytes``,
``read_into`` with the parallel drain, ``decode``, ``stats``, ``close``)
and ``NativeRingSource``. A producer thread in C++ pulls uint8 I/Q into a
lock-free ring with nanosecond block timestamps and drop accounting; the
caller drains fixed blocks.

The library is built from the repository's own ``native/ingest.cpp`` and
``native/ring_buffer.hpp`` with ``g++`` (the flags of ``native/Makefile``)
at the first open, never at import, under a file lock, into
``radio_mapper_tpu_torch/_build/libringest_<hash>.so``; the name hashes
the sources, the flags and the host CPU's model and flags (``-march=native``
code runs only on a CPU like the one it was built on), so an edited
source, or a checkout copied to another machine, builds anew. When it
cannot be built, opening raises :class:`NativeUnavailable`: the caller
chooses another source, nothing here falls back on its own.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from radio_mapper_tpu_torch.ingest.sources import IQSource

_PKG = Path(__file__).resolve().parents[1]
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
SOURCES = ("ingest.cpp", "ring_buffer.hpp")
CXXFLAGS = ("-O3", "-march=native", "-Wall", "-Wextra", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _host_cpu() -> bytes:
    """The host CPU's model name and feature flags (what ``-march=native``
    compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            return "".join([line for line in f if line.startswith(("model name", "flags"))][:2]).encode()
    except OSError:
        return platform.processor().encode()


def library_path() -> Path:
    """Where the ring library for the current sources, flags and host CPU
    lives."""
    h = hashlib.sha256(_host_cpu())
    for name in SOURCES:
        path = NATIVE_DIR / name
        if not path.exists():
            raise NativeUnavailable(f"missing native source {path}")
        h.update(name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libringest_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile ``native/ingest.cpp`` into ``out`` unless another process
    did while this one waited for the lock."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeUnavailable("no C++ compiler (g++) to build the ingest ring")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libringest.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXXFLAGS, "-o", str(tmp), str(NATIVE_DIR / "ingest.cpp")]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeUnavailable(f"cannot build {out.name}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeUnavailable(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def load_library() -> ctypes.CDLL:
    """The ring library, built at the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        c = ctypes
        lib.rmt_ingest_open_file.argtypes = [c.c_char_p, c.c_int, c.c_size_t, c.c_size_t]
        lib.rmt_ingest_open_file.restype = c.c_int
        lib.rmt_ingest_open_tcp.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_size_t, c.c_size_t]
        lib.rmt_ingest_open_tcp.restype = c.c_int
        lib.rmt_ingest_open_synthetic.argtypes = [c.c_uint, c.c_size_t, c.c_size_t]
        lib.rmt_ingest_open_synthetic.restype = c.c_int
        lib.rmt_ingest_open_synthetic_paced.argtypes = [c.c_uint, c.c_double, c.c_size_t, c.c_size_t]
        lib.rmt_ingest_open_synthetic_paced.restype = c.c_int
        lib.rmt_ingest_read.argtypes = [
            c.c_int, c.POINTER(c.c_uint8), c.c_size_t, c.c_int, c.POINTER(c.c_int64),
        ]
        lib.rmt_ingest_read.restype = c.c_long
        lib.rmt_ingest_read_mt.argtypes = [
            c.c_int, c.POINTER(c.c_uint8), c.c_size_t, c.c_int, c.POINTER(c.c_int64), c.c_int,
        ]
        lib.rmt_ingest_read_mt.restype = c.c_long
        lib.rmt_ingest_decode.argtypes = [c.POINTER(c.c_uint8), c.c_size_t, c.c_float, c.POINTER(c.c_float)]
        lib.rmt_ingest_stats.argtypes = [
            c.c_int, c.POINTER(c.c_uint64), c.POINTER(c.c_uint64), c.POINTER(c.c_uint64), c.POINTER(c.c_int),
        ]
        lib.rmt_ingest_close.argtypes = [c.c_int]
        _lib = lib
        return lib


class NativeIngest:
    """Low-level handle over the native ring."""

    def __init__(self, handle: int):
        if handle < 0:
            raise NativeUnavailable("native ingest open failed")
        self.handle = handle
        self.lib = load_library()

    @classmethod
    def open_file(cls, path: str, *, loop: bool = True, ring_bytes: int = 1 << 22, chunk_bytes: int = 1 << 16):
        lib = load_library()
        return cls(lib.rmt_ingest_open_file(path.encode(), int(loop), ring_bytes, chunk_bytes))

    @classmethod
    def open_tcp(cls, host: str, port: int, *, rtl_tcp_header: bool = True, ring_bytes: int = 1 << 22,
                 chunk_bytes: int = 1 << 16):
        lib = load_library()
        return cls(lib.rmt_ingest_open_tcp(host.encode(), port, int(rtl_tcp_header), ring_bytes, chunk_bytes))

    @classmethod
    def open_synthetic(cls, seed: int = 0, *, ring_bytes: int = 1 << 22, chunk_bytes: int = 1 << 16):
        """An unpaced xorshift stream. The ring drops an incoming chunk that
        does not fit, so the first ``ring_bytes`` read are the stream's
        first bytes: deterministic for a seed."""
        lib = load_library()
        return cls(lib.rmt_ingest_open_synthetic(seed, ring_bytes, chunk_bytes))

    @classmethod
    def open_synthetic_paced(cls, seed: int = 0, *, bytes_per_s: float, ring_bytes: int = 1 << 24,
                             chunk_bytes: int = 1 << 16):
        """Synthetic source paced to a fixed byte rate (a virtual SDR
        clock): ``stats()['bytes_dropped'] == 0`` after a sustained run is
        the real-time criterion."""
        lib = load_library()
        return cls(lib.rmt_ingest_open_synthetic_paced(seed, float(bytes_per_s), ring_bytes, chunk_bytes))

    def read_bytes(self, nbytes: int, timeout_ms: int = 2000) -> Tuple[np.ndarray, int]:
        out = np.empty(nbytes, np.uint8)
        got, ts = self.read_into(out, timeout_ms)
        return out[:got], ts

    def read_into(self, out: np.ndarray, timeout_ms: int = 2000, *, threads: int = 0) -> Tuple[int, int]:
        """Fill a caller-owned C-contiguous uint8 buffer (a pinned slot's
        view, say) from the ring; with ``threads > 1`` the memcpy runs as a
        parallel drain in C++. Returns ``(bytes_read, block_ts_ns)``."""
        # an explicit raise, not an assert: a bad buffer would become a
        # native out-of-bounds memcpy under python -O
        if out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
            raise ValueError("read_into needs a C-contiguous uint8 buffer")
        ts = ctypes.c_int64(0)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if threads > 1:
            got = self.lib.rmt_ingest_read_mt(self.handle, ptr, out.size, timeout_ms, ctypes.byref(ts), int(threads))
        else:
            got = self.lib.rmt_ingest_read(self.handle, ptr, out.size, timeout_ms, ctypes.byref(ts))
        if got < 0:
            raise IOError("native ingest read failed")
        return int(got), int(ts.value)

    def decode(self, raw: np.ndarray, scale: float = 1.0) -> np.ndarray:
        raw = np.ascontiguousarray(raw, np.uint8)
        out = np.empty(raw.size, np.float32)
        self.lib.rmt_ingest_decode(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), raw.size, ctypes.c_float(scale),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out

    def stats(self) -> dict:
        w, d, c = ctypes.c_uint64(0), ctypes.c_uint64(0), ctypes.c_uint64(0)
        e = ctypes.c_int(0)
        self.lib.rmt_ingest_stats(self.handle, ctypes.byref(w), ctypes.byref(d), ctypes.byref(c), ctypes.byref(e))
        return {"bytes_written": w.value, "bytes_dropped": d.value, "bytes_consumed": c.value, "error": e.value}

    def close(self):
        if self.handle >= 0:
            self.lib.rmt_ingest_close(self.handle)
            self.handle = -1

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeRingSource(IQSource):
    """``IQSource`` backed by the native ring (file, rtl_tcp, synthetic)."""

    def __init__(self, ingest: NativeIngest, *, sample_rate_hz: float = 2_048_000.0,
                 center_frequency_hz: float = 121.5e6):
        self.ingest = ingest
        self.sample_rate_hz = sample_rate_hz
        self.center_frequency_hz = center_frequency_hz
        self.last_block_ts_ns = 0

    def read(self, num_samples: int) -> np.ndarray:
        raw, ts = self.ingest.read_bytes(num_samples * 2)
        self.last_block_ts_ns = ts
        if raw.size < num_samples * 2:
            raw = np.pad(raw, (0, num_samples * 2 - raw.size), constant_values=127)
        f = self.ingest.decode(raw)
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)

    def close(self) -> None:
        self.ingest.close()
