"""Flash-attention kernel: causal (or bidirectional) GQA attention with an
optional sliding window, forward only, on Hopper.

``flash_attention(q, k, v, causal=..., window=...)`` takes q (B, S, Hq, D)
and k, v (B, S, Hkv, D) in the models' layout and returns (B, S, Hq, D) in
q's dtype.  It replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel``.

A CUDA tensor goes to the hand-written kernel ``csrc/flash_attention.cu``;
a CPU tensor goes to the plain PyTorch version,
``repro_torch.kernels.ref.flash_attention_ref``.  There is no fallback
from one to the other: a CUDA call builds and launches the kernel or
raises.  ``LAUNCHES["flash_attention"]`` counts kernel launches and
nothing else.  Like the TPU kernel it has no gradient
(``ops.flash_attention`` refuses a call that would need one).

What bounds it on the card is its tensor-core work, 4 * D operations per
unmasked (query, key) pair.  bf16 inputs (evaluation) run FlashAttention-2
on the tensor cores: ``mma.sync`` bf16 tiles with f32 accumulation for
QK^T and P.V, K/V tiles in a ``cp.async`` ring, the softmax weights P kept
in registers.  P goes into P.V as bf16 hi + lo (two products), because
rounding it to bf16 once would miss the limit of one bf16 output step by
up to 34x; that costs 1.5x the tensor-core work of a single-bf16 P.V.
float32 inputs (the checks and the f32 route comparison) run a
FlashAttention-1 on the CUDA cores, which keeps full f32 (no TF32).  The
note at the top of the ``.cu`` file has the details;
``repro_torch.kernels.flash_variants`` times the bf16 kernel beside
ablated builds of it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 160     # the largest head dim of the configs (stablelm)
LAUNCHES = {"flash_attention": 0}
INPUT_TYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the C entry points' argument and result types set."""
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _library() -> ctypes.CDLL:
    return _bind(_build.load("flash_attention").lib)


def _check(q, k, v, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, S, Hq, D) and k, v one (B, S, Hkv, "
                         f"D) shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k and v must be (B, S, Hkv, D) with B={B}, S={S}, "
                         f"D={D}; got {tuple(k.shape)}")
    Hkv = k.shape[2]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must be on one device")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no sync).

    q, k, v: all float32 or all bfloat16 CUDA tensors whose last dim is
    contiguous (any batch, sequence and head strides)."""
    _check(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors; got "
                         f"{q.device}")
    if q.dtype not in INPUT_TYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k and v must all be float32 or all bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    B, S, Hq, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"the flash_attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}; got D={D}")
    if B * Hq > 65535:
        raise ValueError(f"the flash_attention kernel takes at most 65535 "
                         f"(batch, head) pairs; got {B * Hq}")
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, Hq, k.shape[2], D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), int(window),
            1.0 / math.sqrt(D), int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B, S, Hq, D) attention output: the CUDA kernel for CUDA tensors,
    the plain PyTorch version for CPU tensors."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"no flash_attention kernel for {q.device} tensors")
    _check(q, k, v, window)
    return flash_attention_ref(q, k, v, causal=causal, window=window)
