"""Public wrappers around the kernels.

``population_makespan`` is the M3E fitness hot loop: genome decode and the
table gather run in PyTorch, and the event simulation in the makespan
kernel (``repro_torch.kernels.makespan``).  ``ssm_scan`` is the Mamba
selective scan (``repro_torch.kernels.ssm_scan``).  ``flash_attention``
is the attention of ``models.layers.full_attention`` with ``use_flash``
(``repro_torch.kernels.flash_attention``).  Each takes CUDA tensors to its
hand-written kernel and CPU tensors to its plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.core.bw_allocator import queue_tables
from repro_torch.core.encoding import decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels.makespan import makespan


# lint: dispatch
def population_makespan(accel: torch.Tensor, prio: torch.Tensor,
                        lat: torch.Tensor, bw: torch.Tensor, bw_sys,
                        num_accels: int) -> torch.Tensor:
    """Makespans of a population, in one kernel launch.

    accel (P, G) int32 and prio (P, G) f32 with (G, A) job tables and one
    ``bw_sys`` (a float or a one-element tensor) give (P,).  R rows --
    accel/prio (R, P, G), tables (R, G, A), ``bw_sys`` (R,) or one value
    -- give (R, P): the decode and the table gather run per row in
    PyTorch, the rows are flattened to N = R*P individuals and the kernel
    reads each individual's row's ``bw_sys``.  Tensors on the genomes'
    device."""
    lead = accel.shape[:-1]
    G = accel.shape[-1]
    sched = decode(accel.reshape(-1, G), prio.reshape(-1, G), num_accels)
    qlat, qbw = queue_tables(sched, lat.float(), bw.float())
    return makespan(qlat.contiguous(), qbw.contiguous(), sched.count,
                    bw_sys).reshape(lead)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor):
    """Same contract as ``repro_torch.models.mamba.selective_scan``:
    x, dt (Bt, L, D); A (D, N); B, C (Bt, L, N) -> (y (Bt, L, D) f32,
    h_final (Bt, D, N) f32).

    On the card, x, B and C go to the kernel in float32 or bfloat16 (any
    other type is widened to float32, and B and C to one type), dt and A
    in float32; on the serving path they already are, so nothing is cast
    there.  The kernel wants contiguous rows: the B and C that the blocks
    split off one projection are copied once here.  Forward only, as in
    the JAX package: a call that autograd would have to differentiate
    raises, on every device."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, B, C)):
        raise RuntimeError(
            "ssm_scan is forward-only, as the JAX package's Pallas kernel "
            "is (it has no gradient): train with use_flash=False and "
            "evaluate with use_flash=True under torch.no_grad()")
    if x.device.type == "cuda":
        if x.dtype not in _ssm.INPUT_TYPES:
            x = x.float()
        if B.dtype != C.dtype or B.dtype not in _ssm.INPUT_TYPES:
            B, C = B.float(), C.float()
        x, dt, A = x.contiguous(), dt.float().contiguous(), \
            A.float().contiguous()
        B, C = B.contiguous(), C.contiguous()
    return _ssm.ssm_scan(x, dt, A, B, C)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D) in q's dtype.

    The layout is the models' (sequence-major heads); the kernel reads it
    through strides, so nothing is transposed.  Forward only, as in the
    JAX package: a call that autograd would have to differentiate raises."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only, as the JAX package's Pallas "
            "kernel is (it has no gradient): train with use_flash=False and "
            "evaluate with use_flash=True under torch.no_grad()")
    return _flash.flash_attention(q, k, v, causal=causal, window=window)
