"""Selective-scan kernel: the Mamba-1/2 recurrence on Hopper.

``ssm_scan(x, dt, A, B, C)`` returns ``(y (Bt, L, D) f32, h (Bt, D, N)
f32)`` for ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t``, ``y_t = <h_t,
C_t>`` from a zero state.  It replaces the Pallas TPU kernel
``src/repro/kernels/ssm_scan.py::_ssm_kernel``.

A CUDA tensor goes to the hand-written kernel ``csrc/ssm_scan.cu`` (a
channel's states spread over a few lanes, inputs staged by ``cp.async``,
the y sums through shared memory; see the note at the top of that file;
``repro_torch.kernels.ssm_variants`` times it beside ablated builds);
a CPU tensor goes to the plain PyTorch version,
``repro_torch.models.mamba.selective_scan``.  There is no fallback from
one to the other: a CUDA call builds and launches the kernel or raises.
``LAUNCHES["ssm_scan"]`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.mamba import selective_scan

MAX_STATE = 128        # 32 lanes of at most 4 states each
LAUNCHES = {"ssm_scan": 0}
INPUT_TYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C entry points' argument and result types set."""
    lib.ssm_scan_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.ssm_scan_launch.restype = ctypes.c_int
    lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    return _bind(_build.load("ssm_scan").lib)


def _check(x, dt, A, B, C) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must share a (Bt, L, D) shape; got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    Bt, L, D = x.shape
    if A.dim() != 2 or A.shape[0] != D:
        raise ValueError(f"A must be (D, N) with D={D}; got "
                         f"{tuple(A.shape)}")
    N = A.shape[1]
    for name, t in (("B", B), ("C", C)):
        if t.shape != (Bt, L, N):
            raise ValueError(f"{name} must be (Bt, L, N)={Bt, L, N}; got "
                             f"{tuple(t.shape)}")
    if not all(t.device == x.device for t in (dt, A, B, C)):
        raise ValueError("x, dt, A, B and C must be on one device")


def ssm_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on PyTorch's current stream (no sync).

    x, B, C: float32 or bfloat16; dt and A: float32; all contiguous."""
    _check(x, dt, A, B, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan_cuda needs CUDA tensors; got {x.device}")
    if x.dtype not in INPUT_TYPES or B.dtype not in INPUT_TYPES:
        raise TypeError(f"x and B/C must be float32 or bfloat16; got "
                        f"{x.dtype} and {B.dtype}")
    if C.dtype != B.dtype:
        raise TypeError(f"B and C must share a dtype; got {B.dtype} and "
                        f"{C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype} and "
                        f"{A.dtype}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Bt, L, D = x.shape
    N = A.shape[1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"the ssm_scan kernel takes 1..{MAX_STATE} states "
                         f"per channel; got N={N}")
    if Bt > 65535:
        raise ValueError(f"the ssm_scan kernel takes at most 65535 batch "
                         f"rows (one grid row each); got Bt={Bt}")
    y = torch.empty((Bt, L, D), dtype=torch.float32, device=x.device)
    h = torch.empty((Bt, D, N), dtype=torch.float32, device=x.device)
    if L == 0 or Bt == 0 or D == 0:
        return y, h.zero_()
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssm_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), h.data_ptr(), Bt, L, D, N,
            int(x.dtype == torch.bfloat16), int(B.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError("ssm_scan kernel launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    LAUNCHES["ssm_scan"] += 1
    return y, h


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_final): the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors."""
    if x.device.type == "cuda":
        return ssm_scan_cuda(x, dt, A, B, C)
    if x.device.type != "cpu":
        raise ValueError(f"no ssm_scan kernel for {x.device} tensors")
    _check(x, dt, A, B, C)
    return selective_scan(x, dt, A, B, C)
