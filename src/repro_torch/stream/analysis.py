"""Async analysis stage — JobAnalyzer tables concurrently with device compute.

A port of ``repro.stream.analysis``.  The tables go through the port's
``JobAnalyzer`` (bitwise the reference's, under the same lock), and
every ``FitnessFn`` is built on the host: the service stacks a batch's
tables and copies them to its device in one go.

The Job Analyzer is pure-host numpy (cost-model loops over (job, sub)
pairs) and, in the batch workflow, serializes in front of every sweep:
the device idles while the host profiles, then the host idles while the
device searches.  This stage breaks that serialization with a bounded
pool of worker threads: each ``ScenarioRequest`` is turned into a
ready-to-search scenario (job group -> ``JobAnalysisTable`` ->
``FitnessFn``) off the main thread, so the admission stage can keep the
device fed with already-analyzed scenarios while the next ones are still
being profiled.

Threads, not processes, on purpose: the analyzer is numpy-bound (releases
the GIL in array kernels) and the profile cache is the win — one shared,
lock-guarded ``JobAnalyzer`` per accelerator setting (see the
thread-safety contract in ``repro_torch.core.job_analyzer``) means every
worker benefits from every other worker's profiled (layer, sub) pairs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.fitness import FitnessFn
from repro_torch.core.job_analyzer import JobAnalyzer
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.stream.workloads import ScenarioRequest

GB = 1024 ** 3


def _deprioritize_worker(niceness: int = 15) -> None:
    """Lower THIS thread's scheduling priority (Linux per-thread nice).

    Analysis is the background stage: on a host whose cores also run the
    threads that issue device work (or compute on the CPU), an
    analysis worker at normal priority steals cycles from the device
    batches it is supposed to be hidden behind (the reference measured a
    ~40% slowdown of its CPU-backend batches on two cores).  Niced
    workers soak only the slack the device leaves.  Best-effort:
    unsupported platforms just keep default priority."""
    try:
        os.setpriority(os.PRIO_PROCESS, threading.get_native_id(),
                       niceness)
    except (AttributeError, OSError):   # non-Linux / restricted
        pass


def scale_jobs(jobs, batch_scale: int):
    """Rescale every job's mini-batch by the tenant's ``batch_scale``.

    conv/dwconv carry the batch in ``N``; FC/GEMM jobs carry it in the
    GEMM M dim (``Y`` — see ``repro_torch.costmodel.layers``).  Distinct scales
    produce distinct ``profile_key`` digests, so a scale-diverse arrival
    mix keeps the analyzer doing real cost-model work per scenario
    instead of pure cache hits — the recurring host load the async stage
    exists to hide."""
    if batch_scale == 1:
        return list(jobs)
    out = []
    for j in jobs:
        layer = j.layer
        if layer.kind == "fc":
            layer = dataclasses.replace(layer, Y=layer.Y * batch_scale)
        else:
            layer = dataclasses.replace(layer, N=layer.N * batch_scale)
        out.append(dataclasses.replace(j, layer=layer))
    return out


@dataclasses.dataclass
class ReadyScenario:
    """An analyzed scenario, ready for admission to the device queue."""
    request: ScenarioRequest
    fit: FitnessFn
    analysis_start_s: float      # offsets from the service clock's zero
    ready_s: float
    strategy: object = None      # SearchStrategy override; None = service's
    warm: object = None          # strategies.WarmStart memo near-hit seed
                                 # (set at admission; warm rows batch
                                 # separately from cold ones)
    anytime: bool = False        # short-budget interim twin of a
                                 # deadline-carrying scenario (anytime
                                 # mode): routed to the caller, budget
                                 # overridden to the anytime budget
    silent: bool = False         # background full-budget refinement twin:
                                 # recorded to the memo, never routed —
                                 # ranks below every priority class so it
                                 # soaks only device slack
    admitted_s: float = 0.0      # when admission pushed it to the device
                                 # queue (0.0 until then) — the start of
                                 # the obs queue_wait span

    @property
    def analysis_wall_s(self) -> float:
        return self.ready_s - self.analysis_start_s


class AnalysisPool:
    """Bounded thread pool running JobAnalyzer concurrently.

    ``submit`` returns a ``Future[ReadyScenario]``; completion order is
    whatever the workers finish, which is exactly what the admission
    stage wants (it batches whoever is ready).  ``clock`` maps
    ``time.perf_counter()`` to the service's relative timeline.
    ``tracer`` (a ``repro_torch.obs`` span tracer) gets one ``analyze`` span
    per scenario — emitted from the worker threads, which is exactly
    the concurrency the tracer's lock exists for.
    """

    def __init__(self, workers: int = 2, clock=None, tracer=None):
        self.workers = int(workers)
        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix="stream-analysis",
                                        initializer=_deprioritize_worker)
        # keyed by (setting name, flexible flag) — one shared cache per
        # cost-model flavor of each accelerator
        self._analyzers: Dict[Tuple[str, bool], JobAnalyzer] = {}  # @locked:_lock
        self._lock = threading.Lock()
        self._clock = clock or time.perf_counter
        self._tracer = tracer if tracer is not None else NULL_TRACER
        # cleared while the service's thread issues device work
        # (:meth:`paused`); workers wait on it before each scenario
        self._open = threading.Event()
        self._open.set()

    def analyzer_for(self, setting: str, flexible: bool = False
                     ) -> JobAnalyzer:
        """One shared (thread-safe) analyzer per (setting, cost model), so
        concurrent scenarios on the same setting share the profile cache.
        ``flexible`` profiles reconfigurable PE arrays (Fig. 14): the
        model searches candidate array shapes per (layer, sub), an
        order of magnitude more host work per profile."""
        from repro_torch.costmodel import get_setting
        from repro_torch.costmodel.maestro import FlexibleMaestroModel
        with self._lock:
            an = self._analyzers.get((setting, flexible))
            if an is None:
                model = FlexibleMaestroModel() if flexible else None
                an = self._analyzers[(setting, flexible)] = JobAnalyzer(
                    get_setting(setting), model=model)
            return an

    def analyze(self, req: ScenarioRequest,
                fresh_analyzer: bool = False) -> ReadyScenario:
        """Build the job group and analyze it (runs on a worker thread).

        ``fresh_analyzer=True`` profiles with a throwaway analyzer instead
        of the shared per-setting one — the pre-stream ``M3E.prepare``
        behavior (a new ``JobAnalyzer`` per scenario, no cross-scenario
        profile reuse), kept as the baseline ``benchmarks/perf_stream.py``
        measures the service against."""
        from repro_torch.costmodel import get_setting
        from repro_torch.costmodel.maestro import FlexibleMaestroModel
        from repro_torch.workloads import build_task_groups
        t0 = self._clock()
        group = build_task_groups(req.mix, group_size=req.group_size,
                                  seed=req.seed)[0]
        jobs = scale_jobs(group.jobs, req.batch_scale)
        if fresh_analyzer:
            analyzer = JobAnalyzer(
                get_setting(req.setting),
                model=FlexibleMaestroModel() if req.flexible else None)
        else:
            analyzer = self.analyzer_for(req.setting, req.flexible)
        table = analyzer.analyze(jobs)
        fit = FitnessFn(table, bw_sys=req.bw_gb * GB,
                        objective=req.objective, device="cpu")
        t1 = self._clock()
        if self._tracer.enabled:
            self._tracer.emit("analyze", t0, t1, scope=req.uid,
                              setting=req.setting, mix=req.mix,
                              fresh=fresh_analyzer)
        return ReadyScenario(request=req, fit=fit, analysis_start_s=t0,
                             ready_s=t1)

    def submit(self, req: ScenarioRequest) -> "Future[ReadyScenario]":
        return self._pool.submit(self._analyze_when_open, req)

    def _analyze_when_open(self, req: ScenarioRequest) -> ReadyScenario:
        self._open.wait()
        return self.analyze(req)

    @contextlib.contextmanager
    def paused(self):
        """No worker starts a scenario inside the block.  The caller's
        thread issues device work there: every torch call it makes lets
        go of the interpreter lock, and a worker that takes it holds it
        for up to ``sys.getswitchinterval()``, so a dispatch beside two
        busy workers waited tens of milliseconds for its own launches.
        Paused, the workers finish the scenario in hand and wait."""
        self._open.clear()
        try:
            yield
        finally:
            self._open.set()

    def prestart(self) -> None:
        """Spawn all worker threads now (ThreadPoolExecutor starts them
        lazily) so the first streamed scenarios don't pay thread-startup
        latency."""
        from concurrent.futures import wait as _wait
        _wait([self._pool.submit(lambda: None)
               for _ in range(self.workers)])

    def reset(self) -> None:
        """Drop the per-setting analyzers (and their profile caches) —
        lets benchmarks compare runs that do identical analysis work."""
        with self._lock:
            self._analyzers.clear()

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


def analyze_serial(requests: Sequence[ScenarioRequest],
                   pool: Optional[AnalysisPool] = None):
    """Analyze a batch one-by-one on the calling thread — the serial
    baseline ``benchmarks/perf_stream.py`` compares the pipeline against
    (and a convenient helper for tests).  Reuses the pool's analyzers (and
    caches) when one is passed."""
    pool = pool or AnalysisPool(workers=1)
    return [pool.analyze(r) for r in requests]
