"""The 95th percentile, over every request of the window, of the time
from when it was due to when its schedule was delivered, on the
benchmark's clock; a request never delivered counts as late beyond any
limit.  Open loops only."""
import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    if lat is None or not len(lat):
        return None
    return float(np.percentile(lat, 95, method="higher")) * 1e3
