"""Mean card time of one generation loop (a search, or a sweep chunk's
shard), from the program's timing events around each loop (ms)."""
from m3ebench.counters import ratio


def read(ctx):
    return ratio("repro_loop_card_seconds_total", "repro_loop_total", 1e3)
