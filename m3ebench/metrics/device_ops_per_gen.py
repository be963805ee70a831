"""Device operations (kernels, copies, sets) per generation of the
profiled calls: the GA loop's op count, which repeats exactly."""


def read(ctx):
    p = ctx.profile
    if p is None or "rows_per_call" not in p or not p["device"]:
        return None
    return len(p["device"]) / (p["calls"] * p["generations_per_call"])
