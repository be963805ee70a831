"""Mean wait of a stream batch on the card: from the host's finishing its
issue to the card's starting it, behind the batch in flight (ms)."""
from m3ebench.counters import ratio


def read(ctx):
    return ratio("repro_stream_card_queue_seconds_total",
                 "repro_stream_batches_total", 1e3)
