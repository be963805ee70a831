"""Hand-written Hopper kernels for the framework's hot spots.

  makespan   the paper's M3E fitness evaluation (BW-allocator event
             simulation over whole populations), CUDA C++ in
             ``csrc/makespan.cu``

Each kernel has a wrapper (``ops``) and a plain PyTorch version (``ref``);
the kernels are built with ``nvcc`` at first use (``_build``), never at
import.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
