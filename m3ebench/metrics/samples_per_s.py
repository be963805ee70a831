"""Mappings evaluated per second: every sample of every search that
finished in the window (population x generations each), over the
window's whole time.  Closed loops only."""
import numpy as np


def read(ctx):
    w = ctx.window
    if w.latencies_s is not None or not w.answers:
        return None
    return float(np.sum([a.n_samples for a in w.answers])) / w.seconds
