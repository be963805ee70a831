"""Population makespan kernel: the BW-allocator event simulation on Hopper.

``makespan(qlat, qbw, count, bw_sys)`` evaluates ``N`` decoded schedules
of ``G`` jobs on ``A`` sub-accelerators sharing ``bw_sys`` and returns
their ``(N,)`` makespans.  ``bw_sys`` is one value, or one per row of a
population stacked from ``R`` rows (a sweep chunk): an ``(R,)`` tensor
with ``N % R == 0``, individual ``i`` sharing ``bw_sys[i // (N // R)]``.
An individual's makespan depends on its own queues and its row's
``bw_sys`` only, so one launch of R rows gives bitwise the outputs of R
one-row launches.  It replaces the Pallas TPU kernel
``src/repro/kernels/makespan.py::_makespan_kernel``.

A CUDA tensor goes to the hand-written kernel ``csrc/makespan.cu`` (a
group of lanes as wide as A needs per individual, its queues staged in
shared memory; see the note at the top of that file); a CPU tensor
goes to the plain PyTorch version,
``repro_torch.core.bw_allocator.simulate_tables``.  There is no fallback
from one to the other: a CUDA call builds and launches the kernel or
raises.  ``LAUNCHES["makespan"]`` counts the kernel's launches on the path:
each eager launch (the warm generation's before a capture among them),
and at each replay of a CUDA graph the launches captured into it
(``repro_torch.core.strategies.graphs``).  Inside
``_build.counted_into`` a thread's launches go to the dict it names
instead, for the caller to add with ``_build.add_launches``: a
capture's, which each replay adds, and the warm generation's, added at
once and recorded beside the capture.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.bw_allocator import simulate_tables
from repro_torch.kernels import _build

MAX_ACCELS = 32        # one lane per sub-accelerator
LAUNCHES = _build.launch_counter("makespan")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    built = _build.load("makespan")
    lib = built.lib
    lib.makespan_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.makespan_launch.restype = ctypes.c_int
    lib.makespan_error_string.argtypes = [ctypes.c_int]
    lib.makespan_error_string.restype = ctypes.c_char_p
    return lib


def _check(qlat: torch.Tensor, qbw: torch.Tensor, count: torch.Tensor):
    if qlat.dim() != 3 or qbw.shape != qlat.shape:
        raise ValueError(f"qlat and qbw must share a (P, A, G) shape; got "
                         f"{tuple(qlat.shape)} and {tuple(qbw.shape)}")
    P, A, G = qlat.shape
    if count.shape != (P, A):
        raise ValueError(f"count must be (P, A)={P, A}; got "
                         f"{tuple(count.shape)}")
    if qlat.dtype != torch.float32 or qbw.dtype != torch.float32:
        raise TypeError("qlat and qbw must be float32")
    if count.dtype != torch.int32:
        raise TypeError("count must be int32")
    if not (qbw.device == count.device == qlat.device):
        raise ValueError("qlat, qbw and count must be on one device")


# lint: dispatch
def makespan_cuda(qlat: torch.Tensor, qbw: torch.Tensor, count: torch.Tensor,
                  bw_sys) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync).

    ``bw_sys`` is a float, a one-element tensor, or an ``(R,)`` tensor
    with ``R`` dividing the population, on the tables' device; it is used
    as float32."""
    _check(qlat, qbw, count)
    if qlat.device.type != "cuda":
        raise ValueError(f"makespan_cuda needs CUDA tensors; got "
                         f"{qlat.device}")
    P, A, G = qlat.shape
    if not 1 <= A <= MAX_ACCELS:
        raise ValueError(f"the makespan kernel takes 1..{MAX_ACCELS} "
                         f"sub-accelerators (one warp lane each); got A={A}")
    if G < 1:
        raise ValueError("the makespan kernel needs G >= 1 jobs")
    for name, t in (("qlat", qlat), ("qbw", qbw), ("count", count)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((P,), dtype=torch.float32, device=qlat.device)
    if P == 0:
        return out
    if isinstance(bw_sys, torch.Tensor):
        R = bw_sys.numel()
        if bw_sys.device != qlat.device or (R > 1 and (
                bw_sys.dim() != 1 or P % R)):
            raise ValueError(
                f"a tensor bw_sys must be one value or (R,) with R "
                f"dividing the population {P}, on the tables' device; got "
                f"{tuple(bw_sys.shape)} on {bw_sys.device}")
        bw_dev = bw_sys.reshape(R).to(torch.float32).contiguous()
    else:
        R = 1
        # lint: disable=L002(a host number here)
        bw_dev = torch.full((1,), float(bw_sys), dtype=torch.float32,
                            device=qlat.device)
    lib = _library()
    with torch.cuda.device(qlat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.makespan_launch(qlat.data_ptr(), qbw.data_ptr(),
                                  count.data_ptr(), bw_dev.data_ptr(),
                                  out.data_ptr(), P, A, G, P // R, stream)
    if err != 0:
        raise RuntimeError("makespan kernel launch failed: "
                           + lib.makespan_error_string(err).decode())
    _build.count_launch("makespan")
    return out


# lint: dispatch
def makespan(qlat: torch.Tensor, qbw: torch.Tensor, count: torch.Tensor,
             bw_sys) -> torch.Tensor:
    """(N,) makespans: the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors."""
    if qlat.device.type == "cuda":
        return makespan_cuda(qlat, qbw, count, bw_sys)
    if qlat.device.type != "cpu":
        raise ValueError(f"no makespan kernel for {qlat.device} tensors")
    _check(qlat, qbw, count)
    return simulate_tables(qlat, qbw, count, bw_sys)
