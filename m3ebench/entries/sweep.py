"""``sweep``: a closed loop of ``run_sweep`` calls, each one new job
group, analysed once, at every bandwidth of the configuration x
``seeds_per_scenario`` new seeds, as one grid."""
from __future__ import annotations

from typing import List

import numpy as np

from m3ebench.loadgen import SEED_SPACE, Answer, ClosedLoop


class Entry(ClosedLoop):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from repro_torch.costmodel import get_setting
        self.accel = get_setting(config["setting"])
        self.seeds_per = int(traffic["seeds_per_scenario"])
        self.rows = len(self.bws) * self.seeds_per

    def call(self, rng):
        from repro_torch.core.fitness import FitnessFn
        from repro_torch.core.job_analyzer import JobAnalyzer
        from repro_torch.core.sweep import run_sweep
        from repro_torch.workloads import build_task_groups
        draws = rng.integers(0, SEED_SPACE, 1 + self.seeds_per)
        gseed, seeds = int(draws[0]), [int(s) for s in draws[1:]]
        self.calls += 1
        group = build_task_groups(self.cfg["task"], self.cfg["group_size"],
                                  seed=gseed)[0]
        table = JobAnalyzer(self.accel).analyze(group.jobs)
        fits = [FitnessFn(table, bw_sys=bw, device="cpu") for bw in self.bws]
        res = run_sweep(fits, budget=int(self.cfg["budget"]), seeds=seeds,
                        device=self.device)
        return gseed, seeds, res

    def answers(self, got) -> List[Answer]:
        gseed, seeds, res = got
        return [Answer(gseed, seeds[k], bw, float(res.best_fitness[s, k]),
                       np.asarray(res.best_accel[s, k]),
                       np.asarray(res.best_prio[s, k]),
                       np.asarray(res.history_best[s, k]), int(res.n_samples))
                for s, bw in enumerate(self.bws)
                for k in range(self.seeds_per)]
