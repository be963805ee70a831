"""Hand-written Hopper kernels for the framework's hot spots.

  makespan   the paper's M3E fitness evaluation (BW-allocator event
             simulation over whole populations), CUDA C++ in
             ``csrc/makespan.cu``
  ssm_scan   the Mamba-1/2 selective scan that every SSM and hybrid
             prefill layer runs, CUDA C++ in ``csrc/ssm_scan.cu``
  flash_attention
             causal GQA attention with an online softmax and an optional
             sliding window, forward only, that ``full_attention`` runs
             with ``use_flash``, CUDA C++ in ``csrc/flash_attention.cu``

Each kernel has a wrapper (``ops``) and a plain PyTorch version (``ref``);
the kernels are built with ``nvcc`` at first use (``_build``), never at
import.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
