"""The card's idle share of a closed loop's window: 1 - its busy time
(each call's kernel intervals in the profiled calls, times the window's
calls) over the unprofiled window."""


def read(ctx):
    if ctx.busy_s is None or "busy_per_call_s" not in ctx.profile:
        return None
    return 1.0 - ctx.busy_s / ctx.window_s
