"""The card's idle share of the stream's window: 1 - its busy time
(each batch size's kernel intervals in the profiled warm-up, summed over
the window's batches) over the unprofiled window."""


def read(ctx):
    if ctx.busy_s is None or "busy_by_rows_s" not in ctx.profile:
        return None
    return 1.0 - ctx.busy_s / ctx.window_s
