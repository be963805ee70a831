"""Mean card time of a stream batch (its loops, first start to last end,
from the program's timing events) (ms)."""
from m3ebench.counters import ratio


def read(ctx):
    return ratio("repro_stream_batch_card_seconds_total",
                 "repro_stream_batches_total", 1e3)
