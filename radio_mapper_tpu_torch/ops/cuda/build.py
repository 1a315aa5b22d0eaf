"""Build the package's CUDA kernels at first use and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` of the package — one process per
source, all started together — and links the objects into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) under ``radio_mapper_tpu_torch/_build/``. The file
name carries a hash of every file under ``csrc/`` (sources and the
headers they include) and of the flags, so an edited source or header
builds anew and an unchanged tree is loaded as it is.

Each C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the build log
)
LINK_FLAGS = (*GENCODE, "-shared")
TREE_SUFFIXES = (".cu", ".cuh", ".h")  # what the library's hash covers

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        str(Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> Sequence[Path]:
    """The translation units: every ``csrc/*.cu``."""
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _tree() -> Sequence[Path]:
    """Every file the build reads: the sources and the headers they include."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in TREE_SUFFIXES)


def library_path() -> Path:
    """Where the library for the current ``csrc/`` tree and flags lives."""
    _sources()
    h = hashlib.sha256()
    for s in _tree():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"librm_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile each source to an object in parallel, then link them."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objdir = out.with_suffix(f".{os.getpid()}.obj")
    objdir.mkdir(exist_ok=True)
    nvcc = _nvcc()
    log = []
    try:
        jobs = []
        for src in _sources():
            obj = objdir / f"{src.stem}.o"
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for cmd, _, proc in jobs:  # wait for every compile, even after a failure
            text, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode})")
        if not failed:
            cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout)
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode})")
        out.with_suffix(".log").write_text("\n".join(log))
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("nvcc failed: " + ", ".join(failed) + "\n" + "\n".join(log))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        shutil.rmtree(objdir, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if not yet built."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            _lib = ctypes.CDLL(str(path))
    return _lib


def build_log() -> str:
    """nvcc's output for the current library (``-Xptxas -v`` report)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _kernel_name(mangled: str) -> str:
    """A kernel's name with its template arguments from its mangled name:
    ``_ZN12_GLOBAL__N_115gcc_pair_kernelILb1EEEv...`` → ``gcc_pair_kernel<1>``
    (the anonymous namespace's component is skipped)."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = ""
    while True:  # skip the anonymous namespace's component
        m = re.match(r"(\d+)", rest)
        if m is None:
            return mangled
        n = int(m.group(1))
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
        if not name.startswith("_GLOBAL__N"):
            break
    if rest.startswith("I"):
        args = re.match(r"I((?:L[a-z]\d+E)+)E", rest)
        if args:
            name += "<" + ", ".join(re.findall(r"L[a-z](\d+)E", args.group(1))) + ">"
    return name


def ptxas_report(text: str) -> list:
    """Each kernel's line of an ``nvcc -Xptxas -v`` log: ``{"kernel",
    "registers", "spill_stores", "spill_loads", "stack"}`` (bytes), in the
    order ptxas compiled them."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1)), "registers": None, "spill_stores": 0,
                   "spill_loads": 0, "stack": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def kernel(name: str, argtypes: Sequence[type]):
    """The C entry ``name`` with its argument types declared.

    Pointers and the stream must be ``c_void_p``: ctypes would otherwise
    pass a Python int as a 32-bit int and cut the pointer.
    """
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
