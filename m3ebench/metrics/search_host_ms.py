"""The host's part of a search: its mean wall in ``M3E.search`` less its
generation loop's time on the card, by the program's own counters (ms)."""
from m3ebench.counters import totals


def read(ctx):
    t = totals()
    n = t.get("repro_search_total")
    wall = t.get("repro_search_seconds_total")
    card = t.get("repro_search_card_seconds_total")
    if not n or not wall or not card:
        return None
    return 1e3 * (wall - card) / n
