"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``.  The
build happens at first use, into ``build/kernels/`` at the root of the
checkout, and is keyed on a hash of the source and the flags, so an edited
source is rebuilt and never loaded stale.  ``nvcc -Xptxas -v`` output
(registers, shared memory, spills) is kept beside the library.

A load is the port's compile event: :func:`add_load_listener` registers
``fn(name, build_seconds)``, called once for each library a process loads
(``repro_torch.lint.runtime.RecompileGuard`` counts them).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    ptxas_log: str         # nvcc's stderr: the -Xptxas -v report
    build_seconds: float   # 0.0 when an up-to-date library was reused


_lock = threading.Lock()
_loaded: Dict[str, BuiltLibrary] = {}   # @locked:_lock
_name_locks: Dict[str, threading.Lock] = {}   # @locked:_lock
_listeners: List[Callable[[str, float], None]] = []   # @locked:_lock


def add_load_listener(fn: Callable[[str, float], None]) -> None:
    """Call ``fn(name, build_seconds)`` after each library this process
    loads from here on (once a library: later ``load`` calls reuse it)."""
    with _lock:
        _listeners.append(fn)


def remove_load_listener(fn: Callable[[str, float], None]) -> None:
    with _lock:
        if fn in _listeners:
            _listeners.remove(fn)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built from source at first use")


def _compile(name: str) -> BuiltLibrary:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    log = BUILD_DIR / f"lib{name}_{digest}.ptxas.txt"
    seconds = 0.0
    if not (so.exists() and log.exists()):
        tmp = BUILD_DIR / f".lib{name}_{digest}.{os.getpid()}.so"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, check=False)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, so)   # atomic: a concurrent loader never sees a part
    return BuiltLibrary(lib=ctypes.CDLL(str(so)), path=so,
                        ptxas_log=log.read_text(), build_seconds=seconds)


def ptxas_report(log, label):
    """{label: (registers, spill store bytes, spill load bytes)} of the
    kernels in nvcc's -Xptxas -v report to whose mangled names ``label``
    gives a label (None: left out)."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = label(m.group(1))
            if entry:
                out[entry] = [None, None, None]
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def load(name: str) -> BuiltLibrary:
    """The library built from ``csrc/<name>.cu``, building it if needed.

    Each source has its own lock, so threads that load different kernels
    run their ``nvcc`` builds at the same time."""
    with _lock:
        if name in _loaded:
            return _loaded[name]
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        with _lock:
            if name in _loaded:
                return _loaded[name]
        built = _compile(name)
        with _lock:
            _loaded[name] = built
            listeners = list(_listeners)
    for fn in listeners:
        fn(name, built.build_seconds)
    return built
