"""Median, over the window's schedules, of the program's own stamps from
a request's table being ready to its batch's dispatch (ms)."""
import numpy as np


def read(ctx):
    s = ctx.window.stamps
    if s is None or not len(s["ready_s"]):
        return None
    return float(np.median(s["dispatch_s"] - s["ready_s"])) * 1e3
