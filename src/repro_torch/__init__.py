"""PyTorch + CUDA port of ``repro`` (MAGMA / M3E), for NVIDIA Hopper.

The layout mirrors ``repro``: ``costmodel`` and ``workloads`` build the
job-analysis tables, ``core`` holds the M3E mapper (encoding, BW
allocator, fitness, MAGMA, strategies, ``M3E``), ``configs`` and
``models`` the SSM and hybrid language models, ``serve`` the multi-tenant
serving engine that schedules them with MAGMA, and ``kernels`` the
hand-written CUDA kernels with their plain PyTorch versions.  ``convert``
carries the JAX package's arrays across.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.
"""
