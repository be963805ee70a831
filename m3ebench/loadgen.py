"""The one traffic generator's shared parts: what an entry returns, the
seeds, and the closed loop the search and sweep entries share.

A traffic file names its ``entry``; ``entries/<entry>.py`` holds that
entry's ``Entry`` class, which a traffic file's parameters, a
configuration and ``--seed`` drive through set-up, the measured window
and the traced stretch, and whose ``judge`` decides its answers.  The
program's three entry points each have one:

``search``  a closed loop of one client calling ``M3E.search``: each call
            a new job group of the configuration's task and a new search
            seed, on the configuration's bandwidths in turn;
``sweep``   a closed loop of ``run_sweep`` calls: each call one new job
            group, analysed once, at every bandwidth of the configuration
            x ``seeds_per_scenario`` new seeds, as one grid;
``stream``  an open loop of scheduling requests at ``rate_hz`` into one
            ``StreamingScheduler``: a window of ``seconds`` holds
            ``round(rate_hz * seconds)`` arrivals, spread as a Poisson
            process given its count (sorted uniform times), each with its
            own group and search seed.

A new entry is a new file there: ``make_entry`` finds it by the name the
traffic file gives.  Every seed gives the same amount of work, in
another order: the sizes come from the configuration and the traffic
file, only the groups, seeds and arrival times from ``--seed``.  The
end-to-end times are the benchmark's own clock's; the program's answers
are kept for the reference to judge.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from m3ebench import judge, trace

GB = 1024 ** 3
SEED_SPACE = 2 ** 31 - 1
# closed-loop calls made in set-up, untimed: the first captures the
# search's loop, the second runs it as the window does
WARMUP_CALLS = 2
# the stretch of a stream cell's own traffic profiled with the host
PROFILE_SECONDS = 0.3


@dataclasses.dataclass
class Answer:
    """One schedule the program returned, with what it was asked: the
    group's seed, the search's seed and the bandwidth decide it."""
    group_seed: int
    search_seed: int
    bw_sys: float
    best_fitness: float
    best_accel: np.ndarray
    best_prio: np.ndarray
    history_best: Optional[np.ndarray]
    n_samples: int
    batch_scale: int = 1


@dataclasses.dataclass
class Window:
    """What the measured window did, by the benchmark's clock."""
    seconds: float                 # first call (arrival) -> last answer
    calls: int                     # program calls made
    attempted: int                 # schedules asked for
    answers: List[Answer]
    latencies_s: Optional[np.ndarray] = None   # due -> delivered (stream)
    stamps: Optional[Dict[str, np.ndarray]] = None   # program's own stamps
    batches: Optional[List[int]] = None   # padded rows of each batch


def rngs(seed: int, n: int) -> List[np.random.Generator]:
    """``n`` independent generators from ``seed`` (any whole number):
    set-up's inputs, the window's, the traced stretch's."""
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(int(seed)).spawn(n)]


def generations(config: dict) -> int:
    """A search's generations: the budget over the population."""
    return int(config["budget"]) // int(config["population"])


def make_entry(bench, config: dict, traffic: dict, seed: int, device):
    """The traffic's entry (``entries/<traffic["entry"]>.py``), built."""
    return bench.entry(traffic.get("entry"))(config, traffic, seed, device)


class ClosedLoop:
    """Shared by the closed loops: one call at a time, until the window
    has run ``seconds``; the call under way then finishes and counts.
    A call keeps what the program returned as it is; the answers are
    unpacked once the window has closed, so that the benchmark makes no
    garbage of its own inside the window.  A subclass gives ``rows`` (the
    schedules a call asks for), ``call(rng)`` and ``answers(got)``."""

    judge = staticmethod(judge.judge)

    def __init__(self, config, traffic, seed, device):
        self.cfg, self.traffic, self.device = config, traffic, device
        self.warm_rng, self.window_rng, self.trace_rng = rngs(seed, 3)
        self.bws = [float(b) * GB for b in config["bandwidths_gb"]]
        self.calls = 0

    def setup(self) -> None:
        for _ in range(WARMUP_CALLS):
            self.call(self.warm_rng)

    def window(self, seconds: float) -> Window:
        kept = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            kept.append(self.call(self.window_rng))
        elapsed = time.perf_counter() - t0
        return Window(seconds=elapsed, calls=len(kept),
                      attempted=len(kept) * self.rows,
                      answers=[a for got in kept for a in self.answers(got)])

    def profile(self, calls: int) -> dict:
        """Device ops and busy seconds of ``calls`` profiled calls, and a
        further call profiled with the host for its launches and the
        device's idle gaps."""
        dev = trace.profile(lambda: [self.call(self.trace_rng)
                                     for _ in range(calls)])
        host = trace.profile(lambda: self.call(self.trace_rng), host=True)
        return {"calls": calls, "device": dev.device,
                "traced_busy_s": trace.busy_s(dev.device),
                "traced_window_s": dev.wall_s,
                "busy_per_call_s": trace.busy_s(dev.device) / calls,
                "generations_per_call": generations(self.cfg),
                "rows_per_call": self.rows, "host_calls": 1,
                "host_launches": trace.launches(host.host),
                "idle_gaps": trace.idle_gaps(host.device, host.host)}

    def close(self) -> None:
        pass
