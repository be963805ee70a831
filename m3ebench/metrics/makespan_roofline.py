"""The makespan kernel's share of its roofline: the least time of one
launch over all the cell's schedules a generation (``peaks``: operations
and bytes from the shapes, bound by the bytes) over its mean measured
time in the profiled calls.  At these sizes a launch is latency-bound."""
from m3ebench.peaks import makespan_bound_ms
from m3ebench.reference.costmodel import sub_accels


def read(ctx):
    p = ctx.profile
    if p is None or "rows_per_call" not in p:
        return None
    times = [o.end_us - o.start_us for o in p["device"]
             if "makespan" in o.name]
    if not times:
        return None
    n = p["rows_per_call"] * int(ctx.config["population"])
    bound, _ = makespan_bound_ms(n, len(sub_accels(ctx.config["sub_accels"])),
                                 int(ctx.config["group_size"]))
    return 100.0 * bound / (sum(times) / len(times) / 1e3)
