"""Mapping quality: the geometric mean over every schedule of the window
of the reference's lower bound over the reference's makespan of the
returned mapping (at most 1)."""
import numpy as np


def read(ctx):
    if not len(ctx.ratio):
        return None
    return float(np.exp(np.mean(np.log(ctx.ratio))))
