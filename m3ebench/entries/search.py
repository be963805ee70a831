"""``search``: a closed loop of one client calling ``M3E.search``, each
call a new job group of the configuration's task and a new search seed,
on the configuration's bandwidths in turn."""
from __future__ import annotations

from typing import List

import numpy as np

from m3ebench.loadgen import SEED_SPACE, Answer, ClosedLoop


class Entry(ClosedLoop):
    rows = 1

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from repro_torch.core.m3e import M3E
        from repro_torch.costmodel import get_setting
        accel = get_setting(config["setting"])
        self.m3e = [M3E(accel, bw_sys=bw, device=device) for bw in self.bws]

    def call(self, rng):
        from repro_torch.workloads import build_task_groups
        gseed, sseed = (int(x) for x in rng.integers(0, SEED_SPACE, 2))
        k = self.calls % len(self.m3e)
        self.calls += 1
        group = build_task_groups(self.cfg["task"], self.cfg["group_size"],
                                  seed=gseed)[0]
        res = self.m3e[k].search(group, self.cfg["method"],
                                 budget=int(self.cfg["budget"]), seed=sseed)
        return gseed, sseed, self.bws[k], res

    @staticmethod
    def answers(got) -> List[Answer]:
        gseed, sseed, bw, res = got
        return [Answer(gseed, sseed, bw, float(res.best_fitness),
                       np.asarray(res.best_accel), np.asarray(res.best_prio),
                       np.asarray(res.history_best), int(res.n_samples))]
