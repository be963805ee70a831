"""Mean lag of a stream batch's route: from the card's finishing it to
the service's run loop seeing it done (ms)."""
from m3ebench.counters import ratio


def read(ctx):
    return ratio("repro_stream_route_lag_seconds_total",
                 "repro_stream_batches_total", 1e3)
