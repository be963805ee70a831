"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes``.  The
build happens at first use, into ``build/kernels/`` at the root of the
checkout, and is keyed on a hash of the source and the flags, so an edited
source is rebuilt and never loaded stale.  ``nvcc -Xptxas -v`` output
(registers, shared memory, spills) is kept beside the library.

A load is the port's compile event, as is a generation step's capture as
a CUDA graph (``repro_torch.core.strategies.graphs``, reported through
:func:`notify_compile`): :func:`add_compile_listener` registers
``fn(name, seconds)``, called once for each library a process loads and
each graph it captures (``repro_torch.lint.runtime.RecompileGuard``
counts them).

The kernels of the generation loop count their launches here
(:func:`launch_counter`, :func:`count_launch`): each eager launch adds
one to its kernel's plain-integer count, and inside :func:`counted_into`
a thread's launches go to the dict it names instead, for the caller to
add with :func:`add_launches` -- a CUDA graph's capture, whose count each
replay adds, and the warm generation before it, added at once.
"""
from __future__ import annotations

import contextlib
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
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from repro_torch.obs.registry import get_registry

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


def add_compile_listener(fn: Callable[[str, float], None]) -> None:
    """Call ``fn(name, seconds)`` after each compile event of this process
    from here on: a library loaded (once a library: later ``load`` calls
    reuse it; ``seconds`` its build) or a graph captured."""
    with _lock:
        _listeners.append(fn)


def remove_compile_listener(fn: Callable[[str, float], None]) -> None:
    with _lock:
        if fn in _listeners:
            _listeners.remove(fn)


def notify_compile(name: str, seconds: float) -> None:
    """Tell the compile listeners that ``name`` was compiled, and add its
    seconds to the process registry's ``repro_compile_seconds_total``
    (``kind`` "graph" for a graph captured, "kernel" for a library)."""
    get_registry().counter(
        "repro_compile_seconds_total",
        "Seconds of the process's compile events by kind").inc(
            seconds, kind="graph" if name.startswith("cuda graph ")
            else "kernel")
    with _lock:
        listeners = list(_listeners)
    for fn in listeners:
        fn(name, seconds)


# kernel name -> (its {name: launches} dict, the registry counter that
# counts the same or None, that counter's help text)
_launch_counts: Dict[str, Tuple[Dict[str, int], Optional[str], str]] = {}
_into = threading.local()


def launch_counter(name: str, metric: Optional[str] = None,
                   help_text: str = "") -> Dict[str, int]:
    """``{name: 0}``: the count of kernel ``name``'s launches on the path,
    a plain integer its wrapper exposes; with ``metric`` the process
    registry's counter of that name counts them too."""
    counts = {name: 0}
    _launch_counts[name] = (counts, metric, help_text)
    return counts


@contextlib.contextmanager
def counted_into(counts: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Count this thread's launches into ``counts`` for the scope, not
    into the kernels' counts."""
    outer = getattr(_into, "counts", None)
    _into.counts = counts
    try:
        yield counts
    finally:
        _into.counts = outer


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (a graph's captured launches, at its replay) to the
    kernels' counts."""
    for name, n in counts.items():
        total, metric, help_text = _launch_counts[name]
        total[name] += n
        if metric is not None and n:
            get_registry().counter(metric, help_text).inc(n)


def count_launch(name: str) -> None:
    """One launch of kernel ``name``, counted where the thread counts."""
    counts = getattr(_into, "counts", None)
    if counts is None:
        add_launches({name: 1})
    else:
        counts[name] = counts.get(name, 0) + 1


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
    notify_compile(name, built.build_seconds)
    return built
