"""What the kernels' variant timers share: ablated sources, their builds,
the card's name and power limit, and timing on the card.

An ablation is a text edit of a kernel's source made at run time, so the
source keeps no switches for it: a tuple of edits (the text to find, its
replacement) applied together.  Every text must be in the source exactly
once, else the variant fails loudly.
"""
from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.kernels import _build

Edit = Tuple[str, str]


def ablate(src: str, edits: Sequence[Edit], name: str, filename: str) -> str:
    """``src`` with ``edits`` applied, each of whose texts it holds once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation {name}: its text {old[:40]!r} is "
                               f"not in {filename} once; update the "
                               "ablation")
        src = src.replace(old, new)
    return src


def ablated_sources(src: str, ablations: Dict[str, Sequence[Edit]],
                    filename: str) -> Dict[str, str]:
    """{variant: source}: "as_is" and one per ablation of ``src``."""
    out = {"as_is": src}
    for name, edits in ablations.items():
        out[name] = ablate(src, edits, name, filename)
    return out


def _build_one(item: Tuple[str, str, Path]) -> Tuple[str, ctypes.CDLL]:
    name, text, out = item
    src, so = out / f"{name}.cu", out / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    (out / f"lib{name}.ptxas.txt").write_text(proc.stderr)
    return name, ctypes.CDLL(str(so))


def build_all(sources: Dict[str, str], subdir: str
              ) -> Dict[str, ctypes.CDLL]:
    """Build every source into ``build/kernels/<subdir>``, one ``nvcc``
    per source, all started together; each build's ``-Xptxas -v`` report
    goes beside its library (``lib<name>.ptxas.txt``)."""
    out = _build.BUILD_DIR / subdir
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(sources)) as pool:
        return dict(pool.map(_build_one, ((name, text, out) for name, text
                                          in sources.items())))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them;
    exits where there is no card."""
    if not torch.cuda.is_available():
        raise SystemExit("the variant timers time kernels on a CUDA card; "
                         "none is present")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn: Callable[[], object], reps: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn``, by CUDA events around ``reps`` calls
    issued back to back from Python: a call whose host path outlasts its
    device work is timed by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn: Callable[[], object], reps: int, replays: int = 5) -> float:
    """Mean device ms per call of ``fn``: ``reps`` calls captured once in
    a CUDA graph, the graph replayed ``replays`` times between two CUDA
    events.  The host issues one replay, not each launch, so the figure is
    the device's (kernel time plus the graph's gap between launches)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * reps)
    del graph
    return ms
