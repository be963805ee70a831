"""Seconds from the run's start to the window's: imports, the card, the
kernels' build or load, every graph captured and warmed."""


def read(ctx):
    return ctx.setup_s
