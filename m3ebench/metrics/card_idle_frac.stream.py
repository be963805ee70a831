"""The card's idle share of the stream's runs: 1 - the union of its
batches' card intervals (the program's timing events) over the runs'
wall."""
from m3ebench.counters import totals


def read(ctx):
    t = totals()
    busy = t.get("repro_stream_card_busy_seconds_total")
    wall = t.get("repro_stream_run_seconds_total")
    if not busy or not wall:
        return None
    return 1.0 - busy / wall
