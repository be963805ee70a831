"""Host calls that put work on the card (kernel and graph launches,
copies, sets) per search, in a search profiled with the host."""


def read(ctx):
    p = ctx.profile
    if p is None or "host_launches" not in p or p["rows_per_call"] != 1:
        return None
    return p["host_launches"] / p["host_calls"]
