"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at
its 700 W limit) and the least time a kernel's work could take on it.

A roofline share is that least time over the kernel's measured time:
the larger of the operations over the peak rate and the bytes over the
HBM bandwidth.  Bytes count each input read once and each output written
once; operations count what these inputs need.
"""
from __future__ import annotations

from typing import Tuple

PEAK_OPS_PER_S = {
    "bfloat16": 989e12,      # tensor cores, dense
    "float16": 989e12,
    "float8": 1979e12,
    "int8": 1979e12,
    "tf32": 495e12,
    "float32": 67e12,        # CUDA cores, outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12    # 80 GB of HBM3


def bound_ms(ops: float, nbytes: float, precision: str = "float32"
             ) -> Tuple[float, str]:
    """(least milliseconds, "operations" or "bytes": which bounds it)."""
    by_ops = ops / PEAK_OPS_PER_S[precision]
    by_bytes = nbytes / HBM_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def makespan_work(n: int, accels: int, group: int) -> Tuple[float, float]:
    """(operations, bytes) of one makespan launch over ``n`` decoded
    schedules of ``group`` jobs on ``accels`` sub-accelerators.

    Bytes: the queue slots the simulation reads (a schedule's counts sum
    to G, so 2 G float32 of its lat / bw queue tables), its A int32
    counts, its makespan written once.  Operations: G events a schedule,
    each 8 A + 4 float32 operations (the A-way request sum, allocation,
    runtime division and A-way minimum, the remaining-work update; the
    scale's max, division and min and the clock's add)."""
    nbytes = 2 * n * group * 4 + n * accels * 4 + n * 4
    ops = n * group * (8 * accels + 4)
    return float(ops), float(nbytes)


def makespan_bound_ms(n: int, accels: int, group: int) -> Tuple[float, str]:
    """Least time of one makespan launch (float32 arithmetic)."""
    return bound_ms(*makespan_work(n, accels, group), precision="float32")
