"""Whether the program's schedules are right, by the plain reference.

For every schedule the window returned, the reference rebuilds the job
group from its seed, profiles it with the frozen cost model, decodes the
returned genomes, simulates the mapping in float64 and works out what
the program should have reported (the group's FLOPs over the makespan),
and a lower bound on any mapping's makespan.  The numbers compared, each
beside its limit (``limits/<workload>.json``):

``fitness_gap``          the widest relative gap between a reported
                         fitness and the reference's for its mapping:
                         wrong tables, decode, simulation or objective
``makespan_over_bound_p90``  the 90th percentile over the schedules of
                         the makespan over its lower bound: a search
                         that did not search (its state never moved)
                         returns mappings many times the bound.  A
                         percentile and not the worst: a sound search
                         now and then stops far from the bound (one
                         schedule in some thousands of a sound stream
                         run read exactly 4x), and the worst of a run
                         swings with such strays
``duplicate_answers``    schedules whose mapping (every job's
                         sub-accelerator and priority) another schedule of
                         the window returned for another group or search
                         seed: rows that copy other rows, or share one
                         generator (one seed's rows at several bandwidths
                         start from one population and may end on one
                         mapping; the priorities are floats drawn and bred
                         apart, so searches from two seeds never do)
``malformed``            schedules of the wrong shape, genes out of
                         range, a sample count other than the budget, a
                         fitness that is not finite or not the last of
                         its history
``missing``              schedules asked for and never delivered
``compiles_in_window``   kernel builds and graph captures inside the
                         window
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from m3ebench.reference import costmodel, schedule, zoo

CHECKS = ("fitness_gap", "makespan_over_bound_p90", "duplicate_answers",
          "malformed", "missing", "compiles_in_window")


class Reference:
    """The reference for one configuration; profiles are cached across
    the groups it judges."""

    def __init__(self, config: dict):
        self.cfg = config
        self.subs = costmodel.sub_accels(config["sub_accels"])
        self._profiles: Dict = {}
        self._tables: Dict[Tuple[int, int], schedule.Tables] = {}

    def tables(self, group_seed: int, batch_scale: int = 1
               ) -> schedule.Tables:
        key = (group_seed, batch_scale)
        if key not in self._tables:
            jobs = zoo.job_group(self.cfg["models"], self.cfg["group_size"],
                                 group_seed)
            jobs = schedule.scale_batch(jobs, batch_scale)
            self._tables[key] = schedule.tables(jobs, self.subs,
                                                self._profiles)
        return self._tables[key]

    def evaluate(self, answers: Sequence, rnd=None, block: int = 4096
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(fitness, lower bound / makespan) of each answer's mapping, by
        the reference, in float64 or under ``rnd``'s rounding; in blocks
        of ``block`` schedules."""
        A = len(self.subs)
        fit, ratio = [], []
        for lo in range(0, len(answers), block):
            part = answers[lo:lo + block]
            tabs = [self.tables(a.group_seed, a.batch_scale) for a in part]
            lat = np.stack([t.lat for t in tabs])
            bw = np.stack([t.bw for t in tabs])
            bw_sys = np.array([a.bw_sys for a in part])
            queue, count = schedule.decode(
                np.stack([a.best_accel for a in part]),
                np.stack([a.best_prio for a in part]), A)
            ms = schedule.makespans(queue, count, lat, bw, bw_sys, rnd=rnd)
            flops = np.array([t.flops for t in tabs])
            fit.append(flops / ms)
            ratio.append(schedule.lower_bound(lat, bw, bw_sys) / ms)
        return np.concatenate(fit), np.concatenate(ratio)


def malformed(answers: Sequence, config: dict) -> int:
    """Answers whose form is wrong, whatever their values."""
    G, A = int(config["group_size"]), len(
        costmodel.sub_accels(config["sub_accels"]))
    bad = 0
    for a in answers:
        accel, prio = np.asarray(a.best_accel), np.asarray(a.best_prio)
        ok = (accel.shape == (G,) and prio.shape == (G,)
              and np.issubdtype(accel.dtype, np.integer)
              and accel.min() >= 0 and accel.max() < A
              and np.all(np.isfinite(prio))
              and a.n_samples == int(config["budget"])
              and np.isfinite(a.best_fitness) and a.best_fitness > 0)
        if ok and a.history_best is not None and len(a.history_best):
            ok = np.float32(a.history_best[-1]) == np.float32(a.best_fitness)
        bad += not ok
    return bad


def duplicates(answers: Sequence) -> int:
    """Answers whose mapping an answer for another group or search seed
    returned too (each such answer beyond the first of its mapping)."""
    asked: Dict[bytes, set] = {}
    for a in answers:
        mapping = (np.ascontiguousarray(a.best_accel, np.int64).tobytes()
                   + np.ascontiguousarray(a.best_prio, np.float32).tobytes())
        asked.setdefault(mapping, set()).add((a.group_seed, a.search_seed))
    return sum(len(q) - 1 for q in asked.values())


def judge(config: dict, answers: List, attempted: int,
          compiles: int) -> Tuple[Dict[str, float], np.ndarray]:
    """(the numbers compared, each schedule's lower bound / makespan)."""
    n_bad = malformed(answers, config)
    good = [a for a in answers if not malformed([a], config)] \
        if n_bad else answers
    numbers = {"duplicate_answers": float(duplicates(answers)),
               "malformed": float(n_bad),
               "missing": float(attempted - len(answers)),
               "compiles_in_window": float(compiles)}
    if good:
        ref_fit, ratio = Reference(config).evaluate(good)
        got = np.array([a.best_fitness for a in good])
        numbers["fitness_gap"] = float(np.max(np.abs(got - ref_fit)
                                              / ref_fit))
        numbers["makespan_over_bound_p90"] = over_bound_p90(ratio)
    else:
        ratio = np.zeros(0)
        numbers["fitness_gap"] = float("inf")
        numbers["makespan_over_bound_p90"] = float("inf")
    return {k: numbers[k] for k in CHECKS}, ratio


def over_bound_p90(ratio) -> float:
    """90th percentile of makespan / lower bound, from each schedule's
    lower bound / makespan."""
    return float(np.percentile(1.0 / np.asarray(ratio), 90,
                               method="higher"))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a number with no limit, or
    one that is not a number, fails)."""
    return all(k in limits and np.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())
