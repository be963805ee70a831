"""Mean host time of a search's job analysis into its fitness tables
(``M3E.prepare``), by the program's own counters (ms)."""
from m3ebench.counters import ratio


def read(ctx):
    return ratio("repro_search_prepare_seconds_total", "repro_search_total",
                 1e3)
