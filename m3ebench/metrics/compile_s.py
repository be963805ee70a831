"""Seconds of the process's compile events: CUDA graphs captured and
kernel libraries built, by the program's own counter."""
from m3ebench.counters import totals


def read(ctx):
    return totals().get("repro_compile_seconds_total") or None
