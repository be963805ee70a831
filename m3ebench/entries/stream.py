"""``stream``: an open loop of scheduling requests at ``rate_hz`` into
one ``StreamingScheduler``: a window of ``seconds`` holds
``round(rate_hz * seconds)`` arrivals, spread as a Poisson process given
its count (sorted uniform times), each with its own group and search
seed (a request's one seed is both)."""
from __future__ import annotations

import time
from typing import List

import numpy as np

from m3ebench import judge, trace
from m3ebench.loadgen import (GB, PROFILE_SECONDS, SEED_SPACE, Answer,
                              Window, generations, rngs)


def stamped_scheduler(base):
    """``base`` (the program's ``StreamingScheduler``) with the
    benchmark's own clock on it: the run's zero, taken as the service
    resets its clock, and each schedule's delivery, taken once the
    service has routed the batch that holds it."""

    class Stamped(base):
        def _begin_run(self):
            super()._begin_run()
            self.bench_zero = time.perf_counter()
            self.bench_delivered = {}

        def _route(self, inf, results):
            n = len(results)
            super()._route(inf, results)
            now = time.perf_counter()
            for r in results[n:]:
                self.bench_delivered[r.request.uid] = now

    return Stamped


class Entry:
    judge = staticmethod(judge.judge)

    def __init__(self, config, traffic, seed, device):
        from repro_torch.stream.service import (StreamConfig,
                                                StreamingScheduler)
        self.cfg, self.traffic, self.device = config, traffic, device
        self.warm_rng, self.window_rng, self.trace_rng = rngs(seed, 3)
        self.rate = float(traffic["rate_hz"])
        self.svc = stamped_scheduler(StreamingScheduler)(
            budget=int(config["budget"]),
            stream=StreamConfig(**traffic.get("stream", {})),
            device=device)

    def requests(self, rng, seconds: float):
        """``round(rate * seconds)`` requests due over ``seconds``."""
        from repro_torch.stream.workloads import ScenarioRequest
        n = max(1, int(round(self.rate * seconds)))
        times = np.sort(rng.uniform(0.0, seconds, n))
        seeds = rng.choice(SEED_SPACE, size=n, replace=False)
        bws = self.cfg["bandwidths_gb"]
        return [ScenarioRequest(
            uid=i, arrival_s=float(times[i]), mix=self.cfg["task"],
            setting=self.cfg["setting"], bw_gb=float(bws[i % len(bws)]),
            group_size=int(self.cfg["group_size"]), seed=int(seeds[i]))
            for i in range(n)]

    def setup(self) -> None:
        """Every batch size captured (the service's warm-up), then a
        stretch of the cell's own traffic, untimed: the analysis workers
        started and their profile caches filled as in a running service."""
        self.svc.warmup(self.requests(self.warm_rng, 1.0))
        self.svc.run(self.requests(
            self.warm_rng, float(self.traffic.get("warm_seconds", 0.0))))

    def window(self, seconds: float) -> Window:
        reqs = self.requests(self.window_rng, seconds)
        results = self.svc.run(reqs)
        zero = self.svc.bench_zero
        delivered = self.svc.bench_delivered
        end = max(delivered.values(), default=zero)
        due = {r.uid: zero + r.arrival_s for r in reqs}
        lat = np.array([delivered[r.uid] - due[r.uid] if r.uid in delivered
                        else np.inf for r in reqs])
        answers = [Answer(int(r.request.seed), int(r.request.seed),
                          r.request.bw_gb * GB,
                          float(r.best_fitness), np.asarray(r.best_accel),
                          np.asarray(r.best_prio),
                          np.asarray(r.history_best), int(r.n_samples),
                          int(r.request.batch_scale))
                   for r in results if r.request.uid in delivered]
        stamps = {k: np.array([getattr(r, k) for r in results])
                  for k in ("arrival_s", "analysis_start_s", "ready_s",
                            "dispatch_s", "done_s")}
        return Window(seconds=end - zero, calls=len(self.svc.last_batches),
                      attempted=len(reqs), answers=answers,
                      latencies_s=lat, stamps=stamps,
                      batches=[b.padded_rows for b in self.svc.last_batches])

    def profile(self, calls: int) -> dict:
        """The device time of each batch size (the service's warm-up
        issues one batch of each, back to back, under the profiler) and a
        short stretch of the stream itself profiled with the host, for
        its device ops and idle gaps."""
        reqs = self.requests(self.trace_rng, 1.0)
        warm = trace.profile(lambda: self.svc.warmup(reqs[:1]))
        batches = trace.split_batches(warm.device, generations(self.cfg))
        sizes = self._buckets()
        if len(batches) != len(sizes):
            raise RuntimeError(f"the profiled warm-up ran {len(batches)} "
                               f"batches, want one of each of {sizes}")
        short = self.requests(self.trace_rng, PROFILE_SECONDS)
        host = trace.profile(lambda: self.svc.run(short), host=True)
        return {"calls": len(sizes),
                "busy_by_rows_s": {r: trace.busy_s(b)
                                   for r, b in zip(sizes, batches)},
                "device": host.device,
                "traced_busy_s": trace.busy_s(host.device),
                "traced_window_s": host.wall_s,
                "idle_gaps": trace.idle_gaps(host.device, host.host),
                "generations_per_call": generations(self.cfg)}

    def _buckets(self) -> List[int]:
        out, b = [], 1
        cap = self.svc.stream.batch_rows
        while True:
            out.append(min(b, cap))
            if b >= cap:
                return out
            b *= 2

    def close(self) -> None:
        self.svc.close()
