"""Median, over the window's schedules, of the program's own stamps from
a request's arrival to its job analysis table being ready (ms)."""
import numpy as np


def read(ctx):
    s = ctx.window.stamps
    if s is None or not len(s["ready_s"]):
        return None
    return float(np.median(s["ready_s"] - s["arrival_s"])) * 1e3
